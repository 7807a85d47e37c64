"""What the flash wrappers hand the Hopper kernels, checked on the CPU.

The bf16 kernels load their tiles with TMA through a (head_dim, head,
seq, batch) tensor map, so ``_kernel_operand`` must pass the layouts such
a map can read (views of the fused qkv product among them) without a copy
and copy every other one. ``chip_smoke.ptxas_report`` turns the build's
``-Xptxas -v`` log into the per-kernel register and spill lines the chip
run prints, by names it reads from nvcc's mangled entry names.
"""

import sys
from pathlib import Path

import pytest
import torch

from sparktorch_tpu_torch.ops.flash_attention import _kernel_operand

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def _qkv_views(b=2, s=8, h=3, d=64):
    qkv = torch.zeros((b, s, 3, h, d), dtype=torch.bfloat16)
    return qkv, qkv.unbind(2)


def test_fused_qkv_views_pass_without_copy():
    qkv, views = _qkv_views()
    for x in views:
        assert _kernel_operand(x) is x
    x = torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16)
    assert _kernel_operand(x) is x


@pytest.mark.parametrize("make", [
    # Head-major memory seen as (b, s, h, d): the head stride outgrows the
    # sequence stride.
    lambda: torch.zeros((2, 3, 8, 64), dtype=torch.bfloat16).transpose(1, 2),
    # A sequence stride that is not a multiple of 16 bytes.
    lambda: torch.zeros((2, 8, 3, 68), dtype=torch.bfloat16)[..., :64],
    # A head dim that is not contiguous.
    lambda: torch.zeros((2, 8, 3, 128), dtype=torch.bfloat16)[..., ::2],
    # A base that is not 16-byte aligned.
    lambda: torch.zeros(2 * 8 * 3 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        2, 8, 3, 64),
])
def test_layouts_tma_cannot_read_are_copied(make):
    x = make()
    y = _kernel_operand(x)
    assert y is not x and y.is_contiguous() and torch.equal(y, x)


def test_extent_one_dims_ignore_their_strides():
    # A stride of an extent-1 dim never enters an address, whatever it is.
    x = torch.zeros((8, 3, 64), dtype=torch.bfloat16).unsqueeze(0)
    x = x.as_strided(x.shape, (5, 3 * 64, 64, 1))
    assert _kernel_operand(x) is x
    one_head = torch.zeros((2, 8, 64), dtype=torch.bfloat16).unsqueeze(2)
    assert _kernel_operand(one_head) is one_head


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64EEEvNS_12HopperParamsE",
     "flash_fwd_bf16_kernel<64>"),
    # nvcc's anonymous namespace: a hash, the file name, another hash.
    ("_ZN44_GLOBAL__N__4daee69_12_flash_bwd_cu_7b2654a225flash_bwd_dkv_"
     "bf16_kernelILi128EEEvNS_9DkvParamsE", "flash_bwd_dkv_bf16_kernel<128>"),
    ("_ZN44_GLOBAL__N__4daee69_12_flash_bwd_cu_7b2654a224flash_bwd_dq_"
     "bf16_kernelILi32EEEvNS_8DqParamsE", "flash_bwd_dq_bf16_kernel<32>"),
    ("_ZN43_GLOBAL__N__6c7a8f1_11_fused_ce_cu_b7df2e7313ce_bwd_kernelIfEEvPKT_"
     "PKxPKfS7_PS2_i", "ce_bwd_kernel<f>"),
    ("_Z13ce_fwd_kernelI13__nv_bfloat16EvPKT_xPKxPfS6_i",
     "ce_fwd_kernel<__nv_bfloat16>"),
])
def test_kernel_name_reads_mangled_entries(mangled, name):
    assert chip_smoke.kernel_name(mangled) == name
    if name.startswith("flash_"):
        # The build report prints its threads and dynamic shared memory.
        assert name in chip_smoke.LAUNCH


def test_ptxas_report_names_each_kernel():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64EEEvNS_12HopperParamsE'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z13ce_fwd_kernelI13__nv_bfloat16EvPKT_xPKxPfS6_i' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 29 registers, used 1 barriers, 64 bytes smem",
    ])
    assert chip_smoke.ptxas_report(log) == [
        ("flash_fwd_bf16_kernel<64>", 96, 8, 4, 0),
        ("ce_fwd_kernel<__nv_bfloat16>", 29, 0, 0, 64),
    ]
