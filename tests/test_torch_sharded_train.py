"""The sharded trainer (``train/sharded.py``) on a 2 × 2 (dp, fsdp) mesh against the JAX package's.

A gloo world of 4 ranks (``tests/test_torch_dp.py``'s seeded spawn
helper) builds ``MeshConfig(dp=2, fsdp=2)`` (HSDP: replicated over dp,
sharded over fsdp) and takes three Adam steps of a tiny CausalLM with
``make_sharded_train_step``, from the JAX ``create_sharded_state``'s
initial weights, on a batch whose weight-0 rows fall unevenly over the
shards (5 of 8 rows real: 2 + 2 + 1 + 0), beside the JAX
``make_sharded_train_step`` on a JAX mesh of the same shape: losses,
global grad norms and parameters within 1e-4 (a port that averaged the
gradients by the world size would be off by the shards' weights). The
health vector's per-leaf norms and update ratio equal a one-process
step's on the whole batch, within 1e-5 (the dp replicas are not counted
twice). ``tests/test_torch_dp_fsdp.py`` does the same on a 1 × 2 mesh,
with the other trainers. The JAX step compiles while the ranks run.

The spawned ranks import this module, so the JAX package is imported
inside the functions that use it.
"""

import functools

import numpy as np
import torch

from test_torch_dp import start_world

LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
          max_len=8, dtype="float32")
W = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
SHAPES = {2: (1, 2), 4: (2, 2)}
TOL = 1e-4


def lm_data():
    ids = np.random.default_rng(0).integers(0, LM["vocab_size"], (8, 9))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def comparable(key, value):
    # The key third of the qkv bias has an exactly-zero gradient, so
    # Adam steps on each package's rounding noise there.
    if key.endswith("attn.qkv.bias"):
        return value.reshape(3, -1)[[0, 2]]
    return value


def jax_init():
    """The JAX CausalLM's ``init`` for key 0 as a port state dict of
    numpy arrays: what ``create_sharded_state`` draws, to the last bits
    of a few values (:func:`jax_sharded` checks it)."""
    import jax
    import jax.numpy as jnp
    from sparktorch_tpu.models import transformer as jax_tf

    from sparktorch_tpu_torch.convert import state_dict_from_flax
    from sparktorch_tpu_torch.models import transformer as torch_tf

    x, _ = lm_data()
    model = jax_tf.CausalLM(jax_tf.TransformerConfig(**LM))
    variables = jax.device_get(jax.jit(model.init)(jax.random.key(0),
                                                   jnp.asarray(x[:1])))
    return {k: v.numpy() for k, v in state_dict_from_flax(
        variables, torch_tf.TransformerConfig(**LM)).items()}


def jax_sharded(shape, init):
    """Three Adam steps of the JAX sharded trainer on a (dp, fsdp) mesh
    from its own initial draw (``init`` within 1e-7 of it): losses, grad
    norms and the final params as a port state dict."""
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
    spec = ModelSpec(module=module, loss="cross_entropy", optimizer="adam",
                     optimizer_params={"lr": 1e-2})
    tx = spec.make_optimizer()
    mesh = jax_build_mesh(JaxMeshConfig(dp=shape[0], fsdp=shape[1]),
                          jax.devices()[:shape[0] * shape[1]])
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


def lm_spec(optimizer="adam", params=None):
    from sparktorch_tpu_torch.models import transformer as torch_tf
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    return ModelSpec(module=torch_tf.CausalLM(torch_tf.TransformerConfig(**LM)),
                     loss="cross_entropy", optimizer=optimizer,
                     optimizer_params=params or {"lr": 1e-2})


def sharded_run(mesh, spec, init, steps=3):
    """``steps`` sharded steps from ``init``; records and the state."""
    from sparktorch_tpu_torch.convert import load_full_state_dict
    from sparktorch_tpu_torch.train.sharded import (
        create_sharded_state,
        make_sharded_train_step,
        shard_batch,
    )
    from sparktorch_tpu_torch.utils.data import DataBatch

    x, y = lm_data()
    state, shardings = create_sharded_state(spec, mesh, device="cpu")
    load_full_state_dict(state.module, {k: torch.from_numpy(v)
                                        for k, v in init.items()})
    run = make_sharded_train_step(spec.loss_fn(), mesh, shardings)
    batch = shard_batch(DataBatch(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(W)), mesh)
    records = []
    for _ in range(steps):
        state, m = run(state, batch)
        records.append(m)
    return records, state, shardings


def reference_run(spec, init, steps=3):
    """The one-process step on the whole batch from ``init``."""
    from sparktorch_tpu_torch.train.step import health_buffer, train_step
    from sparktorch_tpu_torch.utils.data import DataBatch
    from sparktorch_tpu_torch.utils.optim import flax_shapes

    x, y = lm_data()
    module = spec.make_module()
    module.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    opt = spec.make_optimizer(module.parameters(), flax_shapes(module))
    batch = DataBatch(torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(W))
    buf = health_buffer(module)
    records = [train_step(module, spec.loss_fn(), opt, batch, health_buf=buf)
               for _ in range(steps)]
    return records, {k: v.numpy() for k, v in module.state_dict().items()}


def health(records):
    return [(m.health.leaf_norms.numpy(), float(m.health.update_ratio))
            for m in records]


def sharded_job(rank, world, init):
    from torch.distributed.tensor import DTensor

    from sparktorch_tpu_torch.convert import full_state_dict
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dp, fsdp = SHAPES[world]
    mesh = build_mesh(MeshConfig(dp=dp, fsdp=fsdp))
    assert (mesh.dp, mesh.fsdp, mesh.batch_shards) == (dp, fsdp, world)
    records, state, shardings = sharded_run(mesh, lm_spec(), init)
    params = {k: v.numpy() for k, v in full_state_dict(state.module).items()}
    placed = {k: [str(p) for p in v.placements]
              for k, v in state.module.named_parameters()
              if isinstance(v, DTensor)}
    out = dict(losses=[float(m.loss) for m in records],
               norms=[float(m.grad_norm) for m in records],
               examples=[float(m.examples) for m in records],
               health=health(records), params=params, placed=placed,
               shardings=shardings)
    if rank == 0:
        ref, _ = reference_run(lm_spec(), init)
        out["reference_health"] = health(ref)
    return out


def check_against_jax(ranks, want):
    """The ranks' sharded records against :func:`jax_sharded`'s."""
    want_losses, want_norms, want_params = want
    got = ranks[0]
    for other in ranks[1:]:  # every rank holds the same model
        assert other["losses"] == got["losses"]
        for key, value in other["params"].items():
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


def check_placements(got):
    """Every leaf whose rule names fsdp is Shard(d) over the fsdp mesh
    dimension (Replicate over dp); every other leaf is a plain,
    replicated tensor."""
    fsdp = {k: v.index("fsdp") for k, v in got["shardings"].items()
            if "fsdp" in v}
    assert fsdp["backbone.tok_embed.weight"] == 1
    assert set(got["placed"]) == set(fsdp)
    for key, dim in fsdp.items():
        assert got["placed"][key] == ["R", f"S({dim})"]
    assert got["shardings"]["backbone.layers.0.attn.qkv.weight"] == ("tp",)


@functools.lru_cache(maxsize=None)
def _world():
    init = jax_init()
    join = start_world(4, sharded_job, 4, init)
    try:
        want = jax_sharded(SHAPES[4], init)
    finally:
        ranks = join()
    return ranks, want


def test_sharded_steps_match_the_jax_sharded_trainer():
    ranks, want = _world()
    check_against_jax(ranks, want)


def test_fsdp_leaves_are_dtensor_shards_of_their_rule():
    check_placements(_world()[0][0])
