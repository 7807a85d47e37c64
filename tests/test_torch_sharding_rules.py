"""The port's sharding rules and dp × fsdp mesh against the JAX package's.

Every parameter's placement from
``sparktorch_tpu_torch.parallel.sharding_rules.shard_params`` must equal
the JAX ``shard_params`` of the same model on a mesh of the same (dp,
fsdp) shape, once the JAX spec is carried through the convert layout
(a Dense kernel (in, out) is the torch weight (out, in); the qkv kernel
(d, 3, h, hd) is (3·h·hd, d); the proj kernel (h, hd, d) is (d, h·hd)).
The port's placements need only the mesh's shape, so no process group
is made here; ``tests/test_torch_sharded_train.py`` builds the meshes in
gloo worlds and trains on them. The axes that are not ported raise.
"""

import numpy as np
import pytest
import torch

from sparktorch_tpu_torch.models import transformer as torch_tf
from sparktorch_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    MeshConfig,
    batch_sharding,
    build_mesh,
    fsdp_param_sharding,
    param_shardings,
    replicated,
)
from sparktorch_tpu_torch.parallel.sharding_rules import shard_params
from sparktorch_tpu_torch.train import sharded

# vocab 98: the LM head's bias splits over fsdp 2 but not over fsdp 4;
# the pooler's square kernel takes the first of its equal dims.
BASE = dict(vocab_size=98, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=12, dtype="float32", n_classes=3)
MOE = dict(BASE, n_experts=4, moe_every=2)
MODELS = {"causal_lm": ("CausalLM", BASE), "classifier":
          ("SequenceClassifier", BASE), "moe_lm": ("CausalLM", MOE),
          "tied_lm": ("CausalLM", dict(BASE, tie_embeddings=True))}
SHAPES = [(2, 2), (1, 4), (4, 1)]


def _flax_groups(path, ndim):
    """For a Flax leaf: the Flax dims that make each port dim, in the
    layouts ``convert.state_dict_from_flax`` writes."""
    module, leaf = path[-2], path[-1]
    if leaf == "kernel" and module == "qkv":      # (d, 3, h, hd)
        return [(1, 2, 3), (0,)]
    if leaf == "kernel" and module == "proj":     # (h, hd, d)
        return [(2,), (0, 1)]
    if leaf == "kernel" and ndim == 2:
        return [(1,), (0,)]
    if leaf == "bias" and module == "qkv":        # (3, h, hd)
        return [(0, 1, 2)]
    return [(d,) for d in range(ndim)]


def _port_spec(path, spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    out = []
    for dims in _flax_groups(path, ndim):
        axes = [spec[d] for d in dims if spec[d] is not None]
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jax_placements(kind, cfg, shape):
    import jax
    import jax.numpy as jnp
    from sparktorch_tpu.models import transformer as jax_tf
    from sparktorch_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from sparktorch_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from sparktorch_tpu.parallel.sharding_rules import shard_params as jax_shard

    from sparktorch_tpu_torch.convert import _convert_leaf

    model = getattr(jax_tf, kind)(jax_tf.TransformerConfig(**cfg))
    abstract = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, cfg["max_len"]), jnp.int32)),
        jax.random.key(0))["params"]
    mesh = jax_build_mesh(JaxMeshConfig(dp=shape[0], fsdp=shape[1]),
                          jax.devices()[:shape[0] * shape[1]])
    specs = jax.tree_util.tree_flatten_with_path(jax_shard(abstract, mesh))[0]
    out = {}
    for keys, sharding in specs:
        path = tuple(k.key for k in keys)
        dims = _at(abstract, path).shape
        name, _ = _convert_leaf("params", path, np.zeros(dims))
        out[name] = _port_spec(path, sharding.spec, len(dims))
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"dp{s[0]}xfsdp{s[1]}")
@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_leaf_is_placed_as_the_jax_rules_place_it(model, shape):
    kind, cfg = MODELS[model]
    with torch.device("meta"):
        module = getattr(torch_tf, kind)(torch_tf.TransformerConfig(**cfg))
    mesh = Mesh(MeshConfig(dp=shape[0], fsdp=shape[1]).resolve(
        shape[0] * shape[1]))
    got = shard_params(module, mesh)
    want = _jax_placements(kind, cfg, shape)
    assert got == want
    # The tp-matched leaves keep their (size-1) tp spec, replicated.
    tp = {k for k, v in got.items() if "tp" in v}
    assert any(k.endswith("attn.qkv.weight") for k in tp)
    if model == "moe_lm":
        assert got["backbone.layers.1.moe.moe_w_in"] == ("ep", None, "tp")
    if shape[1] > 1:
        assert got[next(k for k in got if k.endswith("tok_embed.weight"))] \
            == ("tp", "fsdp")


def test_mesh_vocabulary_matches_the_jax_mesh_module():
    import jax
    from sparktorch_tpu.parallel import mesh as jax_mesh

    mesh = Mesh(MeshConfig(fsdp=4).resolve(8))
    assert mesh.shape["dp"] == 2 and mesh.batch_shards == 8
    assert mesh.batch_group is None and mesh.fsdp_group is None
    jm = jax_mesh.build_mesh(jax_mesh.MeshConfig(fsdp=4), jax.devices()[:8])
    assert BATCH_AXES == jax_mesh.BATCH_AXES
    assert batch_sharding(mesh) == tuple(jax_mesh.batch_sharding(jm).spec)
    assert replicated(mesh) == tuple(jax_mesh.replicated(jm).spec)
    leaves = {"a": np.zeros((6, 8)), "b": np.zeros((3, 5)),
              "c": np.zeros((8, 8)), "d": np.zeros(()), "e": np.zeros((12,))}
    want = jax_mesh.param_shardings(jm, leaves)
    got = param_shardings(mesh, {k: torch.from_numpy(v)
                                 for k, v in leaves.items()})
    for k in leaves:
        spec = list(want[k].spec)
        while spec and spec[-1] is None:
            spec.pop()
        assert got[k] == tuple(spec), k
    assert fsdp_param_sharding(mesh, (6, 8)) == (None, "fsdp")


def test_mesh_config_resolves_dp_times_fsdp():
    assert MeshConfig(fsdp=2).resolve(4)["dp"] == 2
    assert MeshConfig(dp=2, fsdp=2).resolve(4)["fsdp"] == 2
    with pytest.raises(ValueError, match="world size"):
        MeshConfig(fsdp=3).resolve(4)
    with pytest.raises(ValueError, match="world size"):
        MeshConfig(dp=1, fsdp=2).resolve(4)
    # A world of one (no process group): fsdp=2 does not fit.
    with pytest.raises(ValueError, match="world size"):
        build_mesh(MeshConfig(fsdp=2))


@pytest.mark.parametrize("axis,where", [
    ("sp", "step 6 part 3"), ("ep", "step 6 part 4"), ("pp", "step 7")])
def test_axes_not_ported_raise_naming_the_roadmap(axis, where):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{where}"):
        MeshConfig(**{axis: 2})


def test_auto_mesh_and_sequence_sharding_raise():
    mesh = Mesh(MeshConfig().resolve(1))
    loss = torch.nn.functional.cross_entropy
    with pytest.raises(NotImplementedError, match="ROADMAP.*step 7"):
        sharded.make_sharded_train_step(loss, "auto")
    with pytest.raises(NotImplementedError, match="ROADMAP.*step 6 part 3"):
        sharded.make_sharded_train_step(loss, mesh, seq_sharded=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.*step 6 part 3"):
        sharded.batch_specs(True)
    assert sharded.batch_specs(False).w == (BATCH_AXES,)
