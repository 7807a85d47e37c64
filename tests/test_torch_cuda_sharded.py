"""The sharded trainer on the card: an NCCL world of one, ``MeshConfig(fsdp=1)``.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy, the port and ``chip_smoke``, so it runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_sharded.py -q

A small flash CausalLM (bf16 compute, remat) takes 4 steps of
``make_sharded_train_step`` and 4 of the resident ``train_step`` from
the same weights on the same batch: the losses agree within 1e-3
relative, and the sharded steps launch the flash and fused
cross-entropy kernels (``chip_smoke.py``'s sharded phase runs the LM at
full width).
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

CFG = dict(vocab_size=1024, d_model=128, n_heads=2, n_layers=2, d_ff=256,
           max_len=256, attn_impl="flash", remat=True)
STEPS, ROWS = 4, 2


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from sparktorch_tpu_torch.models.transformer import (
        CausalLM,
        TransformerConfig,
    )
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu_torch.train.sharded import (
        create_sharded_state,
        make_sharded_train_step,
        shard_batch,
    )
    from sparktorch_tpu_torch.train.step import train_step
    from sparktorch_tpu_torch.utils.data import DataBatch
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    torch.manual_seed(0)
    spec = ModelSpec(module=CausalLM(TransformerConfig(**CFG)),
                     loss="cross_entropy", optimizer="adamw",
                     optimizer_params={"lr": 3e-4})
    ids = np.random.default_rng(0).integers(0, CFG["vocab_size"],
                                            (ROWS, CFG["max_len"] + 1))
    batch = DataBatch(torch.from_numpy(ids[:, :-1].astype(np.float32)),
                      torch.from_numpy(ids[:, 1:]), torch.ones(ROWS))
    # A copy: an eager spec hands out its own module, which the sharded
    # state copies again from its untrained weights.
    module = copy.deepcopy(spec.make_module()).cuda().train()
    opt = spec.make_optimizer(module.parameters())
    resident = [float(train_step(module, spec.loss_fn(), opt,
                                 batch.to("cuda")).loss)
                for _ in range(STEPS)]
    store = dist.TCPStore("127.0.0.1", chip_smoke.free_port(), 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = build_mesh(MeshConfig(fsdp=1))
        state, shardings = create_sharded_state(spec, mesh, device="cuda")
        run = make_sharded_train_step(spec.loss_fn(), mesh, shardings)
        local = shard_batch(batch, mesh).to("cuda")
        chip_smoke.reset_counts()
        sharded = [float(run(state, local)[1].loss) for _ in range(STEPS)]
        counts = chip_smoke.read_counts()
    finally:
        dist.destroy_process_group()
    return resident, sharded, counts


@pytest.mark.cuda
def test_sharded_losses_match_the_resident_step(runs):
    resident, sharded, _ = runs
    assert np.isfinite(sharded).all() and sharded[-1] < sharded[0]
    np.testing.assert_allclose(sharded, resident, rtol=1e-3)


@pytest.mark.cuda
def test_sharded_steps_launch_the_kernels(runs):
    want = {name: n * STEPS for name, n in
            dict(flash_fwd=2 * CFG["n_layers"], flash_bwd_dq=CFG["n_layers"],
                 flash_bwd_dkv=CFG["n_layers"], ce_fwd=1, ce_bwd=1).items()}
    assert runs[2] == want
