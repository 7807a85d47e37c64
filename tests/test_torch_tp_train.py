"""The sharded trainer on a tp = 2 mesh against the JAX package's.

A gloo world of 2 ranks (``tests/test_torch_dp.py``'s seeded spawn
helper) builds ``MeshConfig(tp=2)``: one batch shard, the tiny CausalLM
of ``tests/test_torch_sharded_train.py`` split over tp (qkv by heads,
proj, the MLP, the embedding and the LM head by vocabulary). Three Adam
steps and three SGD steps from the JAX ``create_sharded_state``'s
initial weights, beside the JAX ``make_sharded_train_step`` on a JAX
mesh of the same shape: losses, global grad norms and parameters within
1e-4. The health vector's per-leaf norms and update ratio equal a
one-process step's on the whole batch within 1e-5, and under SGD the
parameters equal the one-process step's within 1e-6 (a replicated
leaf's gradient scaled by 1/tp would move them by half a step; Adam's
scale invariance would hide it). Each rank holds its own shards: the
qkv weight's rows of its heads in each of q, k and v, the others' slices
of the full tensor. The vocab-parallel embedding reads NaN for an id
outside the vocabulary and only there; an id another rank owns is
looked up there. ``tests/test_torch_tp_dp.py`` and
``tests/test_torch_tp_fsdp.py`` take the same steps in worlds of 4.

The spawned ranks import this module, so the JAX package is imported
inside the functions that use it.
"""

import functools

import numpy as np
import torch

from test_torch_dp import start_world
from test_torch_sharded_train import (
    LM,
    TOL,
    W,
    comparable,
    health,
    jax_init,
    lm_data,
    lm_spec,
    reference_run,
    sharded_run,
)

OPTIMIZERS = (("adam", {"lr": 1e-2}), ("sgd", {"lr": 0.1}))


def jax_tp_sharded(axes, init, optimizer, params):
    """Three steps of the JAX sharded trainer on a mesh of ``axes``
    (``MeshConfig`` keywords) from its own initial draw (``init`` within
    1e-7 of it): losses, grad norms and the final params as a port state
    dict."""
    import jax
    from sparktorch_tpu.models import transformer as jax_tf
    from sparktorch_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from sparktorch_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from sparktorch_tpu.train.sharded import (
        create_sharded_state,
        make_sharded_train_step,
        shard_batch,
    )
    from sparktorch_tpu.utils.data import DataBatch
    from sparktorch_tpu.utils.serde import ModelSpec

    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.models import transformer as torch_tf

    x, y = lm_data()
    module = jax_tf.CausalLM(jax_tf.TransformerConfig(**LM))
    spec = ModelSpec(module=module, loss="cross_entropy", optimizer=optimizer,
                     optimizer_params=params)
    tx = spec.make_optimizer()
    n = int(np.prod(list(axes.values())))
    mesh = jax_build_mesh(JaxMeshConfig(**axes), jax.devices()[:n])
    state, shardings = create_sharded_state(spec, mesh, jax.random.key(0),
                                            sample_x=x[:1], tx=tx)
    target = torch_tf.TransformerConfig(**LM)
    for key, value in state_dict_from_flax(jax.device_get(state.params),
                                           target).items():
        np.testing.assert_allclose(value.numpy(), init[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    step = make_sharded_train_step(module.apply, spec.loss_fn(), tx, mesh,
                                   shardings)
    batch = shard_batch(DataBatch(x, y, W), mesh)
    losses, norms = [], []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m.loss))
        norms.append(float(m.grad_norm))
    final = state_dict_from_flax(jax.device_get(state.params), target)
    return losses, norms, {k: v.numpy() for k, v in final.items()}


def tp_job(rank, axes, init):
    """Adam and SGD sharded runs on ``MeshConfig(**axes)``, each beside
    the one-process step on the whole batch; the first run's local
    shards."""
    from sparktorch_tpu_torch.convert import full_state_dict
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(**axes))
    out = {"mesh": (mesh.dp, mesh.fsdp, mesh.tp, mesh.batch_index,
                    mesh.tp_rank)}
    for name, params in OPTIMIZERS:
        records, state, shardings = sharded_run(mesh, lm_spec(name, params),
                                                init)
        ref, want = reference_run(lm_spec(name, params), init)
        out[name] = dict(
            losses=[float(m.loss) for m in records],
            norms=[float(m.grad_norm) for m in records],
            examples=[float(m.examples) for m in records],
            health=health(records), reference_health=health(ref),
            params={k: v.numpy() for k, v in
                    full_state_dict(state.module).items()},
            reference=want)
        if "local" not in out:
            out["local"] = {k: (v.to_local() if hasattr(v, "to_local")
                                else v).detach().numpy().copy()
                            for k, v in state.module.named_parameters()}
            out["shardings"] = shardings
            out["dtensors"] = sorted(
                k for k, v in state.module.named_parameters()
                if type(v).__name__ == "DTensor")
    return out


def check_against_jax(ranks, name, want):
    """Every rank's ``name`` run against :func:`jax_tp_sharded`'s and the
    one-process step."""
    want_losses, want_norms, want_params = want
    got = ranks[0][name]
    for other in ranks[1:]:  # every rank holds the same model
        assert other[name]["losses"] == got["losses"]
        for key, value in other[name]["params"].items():
            np.testing.assert_array_equal(value, got["params"][key])
    assert got["examples"] == [5.0] * 3
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["norms"], want_norms, rtol=TOL, atol=TOL)
    assert set(got["params"]) == set(want_params)
    for key, value in got["params"].items():
        np.testing.assert_allclose(comparable(key, value),
                                   comparable(key, want_params[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert got["losses"][-1] < got["losses"][0]
    for (leaf, ratio), (want_leaf, want_ratio) in zip(
            got["health"], got["reference_health"]):
        np.testing.assert_allclose(leaf, want_leaf, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ratio, want_ratio, rtol=1e-5)
    if name == "sgd":
        for key, value in got["params"].items():
            np.testing.assert_allclose(value, got["reference"][key],
                                       rtol=1e-6, atol=1e-6, err_msg=key)


def check_local_shards(ranks, tp):
    """Each rank's tp-split leaves (after the Adam run) are its slices
    of the gathered full tensors: the qkv weight and bias by heads in
    each of q, k and v. FSDP2 lays out every leaf whose rule names fsdp
    (a one-rank fsdp axis too) and no other."""
    h, hd = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    for rank in ranks:
        fsdp = sorted(k for k, v in rank["shardings"].items() if "fsdp" in v)
        assert "backbone.tok_embed.weight" in fsdp
        assert rank["dtensors"] == fsdp
        t = rank["mesh"][4]
        local, init = rank["local"], rank["adam"]["params"]
        qkv = "backbone.layers.0.attn.qkv.weight"
        rows = [part * h * hd + head * hd + i for part in range(3)
                for head in range(t * h // tp, (t + 1) * h // tp)
                for i in range(hd)]
        full = init[qkv]
        if rank["shardings"][qkv] == ("tp",):
            np.testing.assert_array_equal(local[qkv], full[rows])
            bias = "backbone.layers.0.attn.qkv.bias"
            np.testing.assert_array_equal(local[bias], init[bias][rows])
        d_ff = LM["d_ff"] // tp
        np.testing.assert_array_equal(
            local["backbone.layers.0.mlp_out.weight"],
            init["backbone.layers.0.mlp_out.weight"][:, t * d_ff:(t + 1)
                                                     * d_ff])
        v = LM["vocab_size"] // tp
        np.testing.assert_array_equal(local["lm_head.weight"],
                                      init["lm_head.weight"][t * v:(t + 1)
                                                             * v])
        # Replicated over tp (and whole here unless fsdp splits it): the
        # LM head's bias.
        if "fsdp" not in rank["shardings"]["lm_head.bias"]:
            np.testing.assert_array_equal(local["lm_head.bias"],
                                          init["lm_head.bias"])


def _embed_job(rank, init):
    """The tp-split LM's logits for ids owned by each rank and ids out
    of range."""
    from sparktorch_tpu_torch.convert import load_full_state_dict
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu_torch.train.sharded import create_sharded_state

    mesh = build_mesh(MeshConfig(tp=2))
    state, _ = create_sharded_state(lm_spec(), mesh, device="cpu")
    load_full_state_dict(state.module, {k: torch.from_numpy(v)
                                        for k, v in init.items()})
    with torch.no_grad():
        logits = state.module(torch.tensor(EMBED_IDS))
    return {"kind": type(state.module.backbone.tok_embed).__name__,
            "logits": logits.numpy()}


# Ids of rank 0's half, of rank 1's half, and out of the vocabulary.
EMBED_IDS = [[0, 5, LM["vocab_size"] // 2, LM["vocab_size"] - 1],
             [1, -1, 2, 3], [LM["vocab_size"], 4, 6, 7]]


def _jobs(rank, init):
    return {"tp": tp_job(rank, {"tp": 2}, init),
            "embed": _embed_job(rank, init)}


@functools.lru_cache(maxsize=None)
def _world():
    init = jax_init()
    join = start_world(2, _jobs, init)
    want = {}
    try:
        for name, params in OPTIMIZERS:
            want[name] = jax_tp_sharded({"tp": 2}, init, name, params)
    finally:
        ranks = join()
    return ranks, want, init


def test_tp2_adam_steps_match_the_jax_sharded_trainer():
    ranks, want, _ = _world()
    assert [r["tp"]["mesh"] for r in ranks] == [(1, 1, 2, 0, 0),
                                                (1, 1, 2, 0, 1)]
    check_against_jax([r["tp"] for r in ranks], "adam", want["adam"])


def test_tp2_sgd_steps_match_the_jax_sharded_trainer_and_one_process():
    ranks, want, _ = _world()
    check_against_jax([r["tp"] for r in ranks], "sgd", want["sgd"])


def test_tp2_ranks_hold_their_shards_by_heads():
    ranks, _, _ = _world()
    check_local_shards([r["tp"] for r in ranks], 2)


def test_vocab_parallel_embedding_reads_nan_for_bad_ids_only():
    from sparktorch_tpu_torch.models import transformer as torch_tf

    ranks, _, init = _world()
    module = torch_tf.CausalLM(torch_tf.TransformerConfig(**LM))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    with torch.no_grad():
        want = module(torch.tensor(EMBED_IDS)).numpy()
    for rank in ranks:
        assert rank["embed"]["kind"] == "VocabParallelEmbed"
        got = rank["embed"]["logits"]
        # A bad id poisons its sequence (its NaN key and value reach
        # every row of the attention); the first sequence's ids are each
        # owned by one rank, all good.
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isfinite(got[0]).all() and np.isnan(got[1:]).all()
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
