"""The tp placements and the mesh's tp axis against the JAX package's.

Every parameter's placement from
``sparktorch_tpu_torch.parallel.sharding_rules.shard_params`` on a mesh
with a tp axis must equal the JAX ``shard_params`` of the same model on
a JAX mesh of the same (dp, fsdp, tp) shape, carried through the
convert layout (``tests/test_torch_sharding_rules.py``). The rules fit
by the Flax dimension: with 2 heads and tp = 4 the qkv and proj weights
fall through to the fsdp rule (``3·h·hd`` would divide), and with
vocabulary 98 the LM head splits over tp = 2 and falls through at tp =
4. The fused qkv weight is split by heads in each of q, k and v; a rank
is its place on the (dp, fsdp) grid for the batch; a mixture-of-experts
model refuses the tp layout. No process group is made here: the worlds
that train are in ``tests/test_torch_tp_*.py``.
"""

import pytest
import torch

from sparktorch_tpu_torch.models import transformer as torch_tf
from sparktorch_tpu_torch.parallel import tp
from sparktorch_tpu_torch.parallel.mesh import Mesh, MeshConfig
from sparktorch_tpu_torch.parallel.sharding_rules import shard_params
from test_torch_sharding_rules import BASE, MODELS, _at, _port_spec

# (dp, fsdp, tp)
SHAPES = [(1, 1, 2), (2, 1, 2), (1, 2, 2), (1, 1, 4), (1, 2, 4)]


def _jax_placements(kind, cfg, shape):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from sparktorch_tpu.models import transformer as jax_tf
    from sparktorch_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from sparktorch_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from sparktorch_tpu.parallel.sharding_rules import shard_params as jax_shard

    from sparktorch_tpu_torch.convert import _convert_leaf

    model = getattr(jax_tf, kind)(jax_tf.TransformerConfig(**cfg))
    abstract = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, cfg["max_len"]), jnp.int32)),
        jax.random.key(0))["params"]
    dp, fsdp, t = shape
    mesh = jax_build_mesh(JaxMeshConfig(dp=dp, fsdp=fsdp, tp=t),
                          jax.devices()[:dp * fsdp * t])
    specs = jax.tree_util.tree_flatten_with_path(jax_shard(abstract, mesh))[0]
    out = {}
    for keys, sharding in specs:
        path = tuple(k.key for k in keys)
        dims = _at(abstract, path).shape
        name, _ = _convert_leaf("params", path, np.zeros(dims))
        out[name] = _port_spec(path, sharding.spec, len(dims))
    return out


def _mesh(shape):
    dp, fsdp, t = shape
    return Mesh(MeshConfig(dp=dp, fsdp=fsdp, tp=t).resolve(dp * fsdp * t))


@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "dp{}xfsdp{}xtp{}".format(*s))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_leaf_is_placed_as_the_jax_rules_place_it_under_tp(model,
                                                                 shape):
    kind, cfg = MODELS[model]
    with torch.device("meta"):
        module = getattr(torch_tf, kind)(torch_tf.TransformerConfig(**cfg))
    got = shard_params(module, _mesh(shape))
    assert got == _jax_placements(kind, cfg, shape)
    qkv = got["backbone.layers.0.attn.qkv.weight"]
    heads_divide = cfg["n_heads"] % shape[2] == 0
    assert (qkv == ("tp",)) == heads_divide
    assert ("tp" in got["backbone.layers.0.attn.proj.weight"]) == heads_divide
    if kind == "CausalLM" and not cfg.get("tie_embeddings"):
        assert (got["lm_head.weight"] == ("tp",)) == (
            cfg["vocab_size"] % shape[2] == 0)


def test_qkv_is_split_by_heads_in_each_of_q_k_v():
    # h = 2, hd = 2: q rows 0-3, k rows 4-7, v rows 8-11.
    full = torch.arange(12 * 3).reshape(12, 3)
    rows = [tp.shard_tensor(full, 0, 3, r, 2)[:, 0] // 3 for r in range(2)]
    assert rows[0].tolist() == [0, 1, 4, 5, 8, 9]
    assert rows[1].tolist() == [2, 3, 6, 7, 10, 11]
    bias = torch.arange(12)
    assert tp.shard_tensor(bias, 0, 3, 1, 2).tolist() == [2, 3, 6, 7, 10, 11]
    # proj (d, h·hd) on dimension 1 and the vocabulary: contiguous.
    w = torch.arange(8).reshape(1, 8)
    assert tp.shard_tensor(w, 1, 1, 1, 4).tolist() == [[2, 3]]


def test_mesh_config_resolves_tp_and_orders_tp_innermost():
    assert MeshConfig(tp=2).resolve(4)["dp"] == 2
    assert MeshConfig(fsdp=2, tp=2).resolve(8)["dp"] == 2
    with pytest.raises(ValueError, match="world size"):
        MeshConfig(tp=3).resolve(4)
    with pytest.raises(ValueError, match="world size"):
        MeshConfig(dp=1, tp=2).resolve(4)
    # A world of one (no process group): tp=2 does not fit.
    with pytest.raises(ValueError, match="world size"):
        MeshConfig(tp=2).resolve(1)
    shape = MeshConfig(dp=2, fsdp=2, tp=2).resolve(8)
    grid = [(m.batch_index, m.tp_rank)
            for m in (Mesh(shape, rank=r) for r in range(8))]
    assert grid == [(b, t) for b in range(4) for t in range(2)]
    mesh = Mesh(shape, rank=5)
    assert (mesh.batch_shards, mesh.world, mesh.tp) == (4, 8, 2)
    assert mesh.tp_group is None and mesh.batch_mesh is None


def test_experts_under_tp_raise_naming_the_roadmap():
    cfg = dict(BASE, n_experts=4, moe_every=2)
    module = torch_tf.CausalLM(torch_tf.TransformerConfig(**cfg))
    mesh = _mesh((1, 1, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP.*step 6 part 4"):
        tp.parallelize(module, mesh, shard_params(module, mesh))
    # tp = 1 lays nothing out.
    one = _mesh((1, 1, 1))
    assert tp.parallelize(module, one, shard_params(module, one)) == {}
