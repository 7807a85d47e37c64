"""The tp path over NCCL: ``MeshConfig(tp=2)`` on two cards, ``MeshConfig(fsdp=2, tp=2)`` on four.

Marked ``cuda``: a case skips unless the machine has a CUDA device for
each of its ranks. It imports only torch, numpy, the port and
``chip_smoke``, so it runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda_tp.py -q

``chip_smoke.py``'s tp pair runs two gloo processes on one card, where
gloo has no all-gather of CUDA tensors and ``parallel/tp.py`` gathers by
summing zero-padded slices. Here NCCL carries every tp collective (the
vocab-split logits through ``all_gather_into_tensor``) and, in the
world of four, FSDP2 shards the token embedding over an NCCL batch mesh.
A small flash CausalLM (bf16 compute, remat, 4 heads of 32) takes
``STEPS`` SGD steps from the same weights on the same batch as the
resident ``train_step`` on one card: every rank's losses within
``chip_smoke.TP_LOSS_RTOL`` relative, each leaf's update within
``chip_smoke.TP_UPDATE_RTOL`` (small updates held to its floor, as the
smoke's pair holds them), every rank's gathered parameters equal, and
each step's kernels launched on the rank's 2 heads.
"""

import copy
import multiprocessing as mp
import os
import queue as _queue
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

CFG = dict(vocab_size=1024, d_model=128, n_heads=4, n_layers=2, d_ff=256,
           max_len=256, attn_impl="flash", remat=True)
STEPS, ROWS, LR, JOIN_S = 3, 4, 0.1, 300


def _spec():
    from sparktorch_tpu_torch.models.transformer import (
        CausalLM,
        TransformerConfig,
    )
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    torch.manual_seed(0)
    return ModelSpec(module=CausalLM(TransformerConfig(**CFG)),
                     loss="cross_entropy", optimizer="sgd",
                     optimizer_params={"lr": LR})


def _batch():
    from sparktorch_tpu_torch.utils.data import DataBatch

    ids = np.random.default_rng(0).integers(0, CFG["vocab_size"],
                                            (ROWS, CFG["max_len"] + 1))
    return DataBatch(torch.from_numpy(ids[:, :-1].astype(np.float32)),
                     torch.from_numpy(ids[:, 1:]), torch.ones(ROWS))


def _rank(rank, world, port, axes, path, results):
    """One NCCL rank: the sharded steps from the reference's weights."""
    import torch.distributed as dist

    from sparktorch_tpu_torch.convert import (
        full_state_dict,
        load_full_state_dict,
    )
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu_torch.train.sharded import (
        create_sharded_state,
        make_sharded_train_step,
        shard_batch,
    )

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        ref = torch.load(path)
        mesh = build_mesh(MeshConfig(**axes))
        spec = _spec()
        state, shardings = create_sharded_state(spec, mesh, device="cuda")
        load_full_state_dict(state.module, ref["init"])
        qkv = state.module.backbone.layers[0].attn.qkv.weight
        heads = qkv.shape[0] // (3 * CFG["d_model"] // CFG["n_heads"])
        batch = shard_batch(_batch(), mesh).to("cuda")
        run = make_sharded_train_step(spec.loss_fn(), mesh, shardings)
        chip_smoke.reset_counts()
        losses = [float(run(state, batch)[1].loss) for _ in range(STEPS)]
        counts = chip_smoke.read_counts()
        dtensors = sorted(k for k, p in state.module.named_parameters()
                          if type(p).__name__ == "DTensor")
        final = full_state_dict(state.module)
        errs, small = chip_smoke.tp_update_errors(ref["init"], final,
                                                  ref["final"])
        results.put((rank, dict(
            losses=losses, counts=counts, heads=heads, dtensors=dtensors,
            fsdp=sorted(k for k, v in shardings.items() if "fsdp" in v),
            update_errs=errs, small=small,
            final={k: v.float().numpy() for k, v in final.items()})))
    except Exception:
        results.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """The resident steps on card 0 (this also builds the kernels before
    any rank starts), saved for the ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sparktorch_tpu_torch.train.step import train_step

    spec = _spec()
    module = copy.deepcopy(spec.make_module()).cuda().train()
    init = {k: v.detach().cpu().clone()
            for k, v in module.state_dict().items()}
    opt = spec.make_optimizer(module.parameters())
    batch = _batch().to("cuda")
    losses = [float(train_step(module, spec.loss_fn(), opt, batch).loss)
              for _ in range(STEPS)]
    final = {k: v.detach().cpu().clone()
             for k, v in module.state_dict().items()}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "reference.pt")
        torch.save(dict(init=init, final=final), path)
        yield path, losses


def _world(world, axes, path):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = chip_smoke.free_port()
    procs = [ctx.Process(target=_rank,
                         args=(r, world, port, axes, path, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, out = results.get(timeout=JOIN_S)
            if not isinstance(out, dict):
                pytest.fail(f"rank {rank} raised:\n{out}")
            got[rank] = out
    except _queue.Empty:
        pytest.fail(f"no result within {JOIN_S} s")
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


@pytest.mark.cuda
@pytest.mark.parametrize("world,axes", [(2, {"tp": 2}),
                                        (4, {"fsdp": 2, "tp": 2})])
def test_tp_over_nccl_matches_the_resident_step(reference, world, axes):
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices, has "
                    f"{torch.cuda.device_count()}")
    path, want = reference
    ranks = _world(world, axes, path)
    per_step = dict(flash_fwd=2 * CFG["n_layers"],
                    flash_bwd_dq=CFG["n_layers"],
                    flash_bwd_dkv=CFG["n_layers"], ce_fwd=1, ce_bwd=1)
    for rank in ranks:
        assert rank["heads"] == CFG["n_heads"] // 2
        assert rank["counts"] == {k: n * STEPS for k, n in per_step.items()}
        assert "backbone.tok_embed.weight" in rank["fsdp"]
        assert rank["dtensors"] == rank["fsdp"]
        assert np.isfinite(rank["losses"]).all()
        np.testing.assert_allclose(rank["losses"], want,
                                   rtol=chip_smoke.TP_LOSS_RTOL)
        worst = max(rank["update_errs"].items(), key=lambda kv: kv[1])
        assert worst[1] <= chip_smoke.TP_UPDATE_RTOL, (worst, rank["small"])
        for key, value in rank["final"].items():
            np.testing.assert_array_equal(value, ranks[0]["final"][key],
                                          err_msg=key)
