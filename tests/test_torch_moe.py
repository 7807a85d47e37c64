"""Mixture-of-experts models in both packages, from the same weights.

The JAX package's ``MoEFFN`` (no mesh: one card, ep = 1) against the
port's, on the same numpy inputs with the Flax params carried across by
``convert.state_dict_from_flax``: the routing (top-k expert indices)
exactly, the outputs and logits, the sown load-balance loss and
(dropped, routed) counts against what the port records in
``collect_moe``, and three ``train_distributed`` steps. The JAX trainer
runs on a one-device mesh there: a shard routes its own rows, so only a
one-device mesh routes the rows the port's one process does (a world of
two is ``tests/test_torch_dp.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparktorch_tpu as jax_pkg
import sparktorch_tpu_torch as port
from sparktorch_tpu.models import transformer as jax_tf
from sparktorch_tpu.parallel.mesh import build_mesh
from sparktorch_tpu.train.sync import train_distributed as jax_train
from sparktorch_tpu.utils.data import DataBatch as JaxBatch
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import transformer as torch_tf
from sparktorch_tpu_torch.train.step import train_step
from sparktorch_tpu_torch.train.sync import train_distributed
from sparktorch_tpu_torch.utils.data import DataBatch
from sparktorch_tpu_torch.utils.losses import resolve_loss

# The JAX package's tests/test_moe.py config; groups of 24 tokens, so a
# batch of 4 × 16 routes in (several) groups that cut across rows.
MOE = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=32, n_experts=4, moe_every=2, dtype="float32",
           moe_group_size=24)


def _ids(b=4, s=16, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)


def _pair(kind, seed=0, **over):
    cfg = dict(MOE, **over)
    jax_model = getattr(jax_tf, kind)(jax_tf.TransformerConfig(**cfg))
    variables = jax.device_get(jax_model.init(jax.random.key(seed),
                                              jnp.zeros((1, 16), jnp.int32)))
    torch_cfg = torch_tf.TransformerConfig(**cfg)
    model = getattr(torch_tf, kind)(torch_cfg)
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               torch_cfg))
    return jax_model, variables["params"], model


def _jax_routing(params, h, cfg, k):
    """The JAX layer's routing of its input ``h`` (b, s, d)."""
    g, n_groups = jax_tf.moe_group_partition(cfg, h.shape[0] * h.shape[1])
    tokens = jnp.asarray(h).reshape(n_groups, g, -1).astype(jnp.float32)
    kernel, bias = params["router"]["kernel"], params["router"]["bias"]
    probs = jax.nn.softmax(tokens @ kernel + bias, axis=-1)
    return jax_tf._top_k_routing(probs, k)


def _torch_routing(layer, h, k):
    g, n_groups = torch_tf.moe_group_partition(layer.config,
                                               h.shape[0] * h.shape[1])
    assert layer.config.moe_top_k == k
    return layer.route(h.reshape(n_groups, g, -1))[1:]


def _assert_same_routing(want_idx, got_idx, what):
    want_idx, got_idx = np.asarray(want_idx), got_idx.numpy()
    flips = np.argwhere(want_idx != got_idx)
    assert not len(flips), (
        f"{what}: {len(flips)} routing choices differ, first at "
        f"(group, token, choice) {tuple(flips[0])}: jax expert "
        f"{want_idx[tuple(flips[0])]}, port {got_idx[tuple(flips[0])]}")


def _sown(sown):
    aux = float(sum(jnp.sum(v) for v in jax.tree.leaves(sown["losses"])))
    flat = jax.tree_util.tree_flatten_with_path(sown["moe_metrics"])[0]
    counts = {"dropped": 0.0, "routed": 0.0}
    for path, leaf in flat:
        names = [str(getattr(p, "key", p)) for p in path]
        for key in counts:
            if key in names:
                counts[key] += float(jnp.sum(leaf))
    return aux, [counts["dropped"], counts["routed"]]


@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_matches_jax(k):
    cfg = dict(MOE, moe_top_k=k, capacity_factor=1.0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    w = np.array([1, 1, 0, 1], np.float32)
    token_w = np.repeat(w[:, None], 16, axis=1)
    jax_cfg = jax_tf.TransformerConfig(**cfg)
    layer = jax_tf.MoEFFN(jax_cfg)
    params = jax.device_get(layer.init(jax.random.key(1), jnp.asarray(x),
                                       jnp.asarray(token_w))["params"])
    want, sown = layer.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(token_w),
                             mutable=["losses", "moe_metrics"])
    port_layer = torch_tf.MoEFFN(torch_tf.TransformerConfig(**cfg))
    port_layer.load_state_dict(state_dict_from_flax(params, port_layer))
    with torch_tf.collect_moe() as stats:
        got = port_layer(torch.from_numpy(x), torch.from_numpy(token_w))

    want_p, want_idx = _jax_routing(params, x, jax_cfg, k)
    got_p, got_idx = _torch_routing(port_layer, torch.from_numpy(x), k)
    _assert_same_routing(want_idx, got_idx, f"MoEFFN k={k}")
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    aux, counts = _sown(sown)
    assert float(stats.aux_total().detach()) == pytest.approx(aux, rel=1e-6)
    assert stats.counts().tolist() == counts
    assert counts[0] > 0  # capacity 1.0 drops some
    # The masked row got no expert output.
    np.testing.assert_array_equal(got[2].detach().numpy(), 0.0)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind", ["CausalLM", "SequenceClassifier"])
def test_moe_model_forward_matches_jax(kind, k):
    jax_model, params, model = _pair(kind, moe_top_k=k)
    ids = _ids()[:, :-1]
    w = np.array([1, 0, 1, 1], np.float32)
    want, sown = jax_model.apply({"params": params}, jnp.asarray(ids),
                                 example_w=jnp.asarray(w),
                                 mutable=["losses", "moe_metrics"],
                                 capture_intermediates=True)
    captured = {}
    hook = model.backbone.layers[1].ln_mlp.register_forward_hook(
        lambda m, i, o: captured.setdefault("h", o))
    with torch_tf.collect_moe() as stats:
        got = model(torch.from_numpy(ids), torch.from_numpy(w))
    hook.remove()

    jax_h = sown["intermediates"]["backbone"]["layer_1"]["ln_mlp"][
        "__call__"][0]
    moe_params = params["backbone"]["layer_1"]["moe"]
    _, want_idx = _jax_routing(moe_params, jax_h, jax_model.config, k)
    _, got_idx = _torch_routing(model.backbone.layers[1].moe,
                                captured["h"], k)
    _assert_same_routing(want_idx, got_idx, f"{kind} k={k}")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    aux, counts = _sown(sown)
    assert float(stats.aux_total().detach()) == pytest.approx(aux, rel=1e-5)
    assert stats.counts().tolist() == counts
    assert counts[1] == k * 3 * 16  # three valid rows route


def test_moe_bf16_forward_matches_jax():
    jax_model, params, model = _pair("CausalLM", dtype="bfloat16",
                                     moe_top_k=2)
    ids = _ids(seed=4)[:, :-1]
    want, sown = jax_model.apply({"params": params}, jnp.asarray(ids),
                                 mutable=["intermediates"],
                                 capture_intermediates=True)
    captured = {}
    hook = model.backbone.layers[1].ln_mlp.register_forward_hook(
        lambda m, i, o: captured.setdefault("h", o))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    hook.remove()
    # The routing first: a flip moves whole tokens between experts.
    jax_h = sown["intermediates"]["backbone"]["layer_1"]["ln_mlp"][
        "__call__"][0]
    _, want_idx = _jax_routing(params["backbone"]["layer_1"]["moe"],
                               np.asarray(jax_h.astype(jnp.float32)),
                               jax_model.config, 2)
    _, got_idx = _torch_routing(model.backbone.layers[1].moe,
                                captured["h"].float(), 2)
    _assert_same_routing(want_idx, got_idx, "bf16 CausalLM k=2")
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * max(1.0, np.abs(want).max()))


def test_moe_lm_train_distributed_matches_jax():
    jax_model, _, model = _pair("CausalLM", moe_top_k=2)
    ids = _ids(seed=3)
    x, y = ids[:, :-1].astype(np.float32), ids[:, 1:]
    kw = dict(criterion="cross_entropy", optimizer="adamw",
              optimizer_params={"lr": 3e-3})
    want = jax_train(jax_pkg.serialize_torch_obj(jax_model, **kw), x,
                     labels=y, iters=3, seed=0,
                     mesh=build_mesh(devices=jax.devices()[:1]))
    got = train_distributed(port.serialize_torch_obj(model, **kw), x,
                            labels=y, iters=3, seed=0, device="cpu")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got.metrics],
                                   [r[key] for r in want.metrics],
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    assert ([r["moe_drop_fraction"] for r in got.metrics]
            == [r["moe_drop_fraction"] for r in want.metrics])
    expected = state_dict_from_flax(want.params, model.config)
    assert set(got.params) == set(expected)
    for key, value in got.params.items():
        value, ref = value.numpy(), expected[key].numpy()
        if key.endswith("attn.qkv.bias"):
            # The key third has a zero gradient in exact arithmetic, so
            # AdamW steps on each package's rounding noise there
            # (tests/test_torch_train_sync.py, ``_comparable``).
            value, ref = value.reshape(3, -1)[[0, 2]], ref.reshape(3, -1)[[0, 2]]
        np.testing.assert_allclose(value, ref, atol=1e-4, rtol=1e-4,
                                   err_msg=key)


def test_moe_padding_rows_masked_from_routing():
    # The JAX package's test through the port: 4 real rows and 4 weight-0
    # rows give the loss of the 4 real rows alone (lr 0, a forward), the
    # junk in the padding slots masked out of a tight capacity.
    jax_model, _, model = _pair("CausalLM", capacity_factor=0.5,
                                moe_group_size=4096)
    ids = np.random.default_rng(0).integers(0, 128, (8, 17)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    w = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    kw = dict(criterion="cross_entropy", optimizer="sgd",
              optimizer_params={"lr": 0.0})
    obj = port.serialize_torch_obj(model, **kw)
    padded = DataBatch(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(w))
    real4 = DataBatch(torch.from_numpy(np.tile(x[:4], (2, 1))),
                      torch.from_numpy(np.tile(y[:4], (2, 1))),
                      torch.from_numpy(w))
    r_pad = train_distributed(obj, padded, iters=1, device="cpu",
                              pre_sharded=True)
    r_real = train_distributed(obj, real4, iters=1, device="cpu",
                               pre_sharded=True)
    np.testing.assert_allclose(r_pad.metrics[0]["loss"],
                               r_real.metrics[0]["loss"], rtol=1e-5)
    assert "moe_drop_fraction" in r_pad.metrics[0]
    # And the same loss as the JAX trainer's on the padded batch.
    want = jax_train(
        jax_pkg.serialize_torch_obj(jax_model, **kw),
        JaxBatch(x=jnp.asarray(x), y=jnp.asarray(y), w=jnp.asarray(w)),
        iters=1, seed=0, mesh=build_mesh(devices=jax.devices()[:1]))
    np.testing.assert_allclose(r_pad.metrics[0]["loss"],
                               want.metrics[0]["loss"], rtol=1e-5)


def _grads_and_stats(model, batch):
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    metrics = train_step(model, resolve_loss("cross_entropy"), opt, batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics, grads


def test_moe_remat_matches_no_remat():
    _, params, plain = _pair("CausalLM", moe_top_k=2)
    remat = torch_tf.CausalLM(torch_tf.TransformerConfig(**MOE, moe_top_k=2,
                                                         remat=True))
    remat.load_state_dict(plain.state_dict())
    ids = _ids(seed=5)
    batch = DataBatch(torch.from_numpy(ids[:, :-1]),
                      torch.from_numpy(ids[:, 1:]),
                      torch.tensor([1.0, 1.0, 0.0, 1.0]))
    m_plain, g_plain = _grads_and_stats(plain, batch)
    m_remat, g_remat = _grads_and_stats(remat, batch)
    assert float(m_remat.loss) == pytest.approx(float(m_plain.loss),
                                                rel=1e-6)
    assert float(m_remat.drop_fraction) == float(m_plain.drop_fraction)
    for name, g in g_plain.items():
        np.testing.assert_allclose(g_remat[name].numpy(), g.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
    # One aux loss per MoE layer: the recompute in the backward records
    # nothing (the block is closed by then).
    with torch_tf.collect_moe() as stats:
        loss = remat(batch.x, batch.w).float().square().mean()
    loss.backward()
    assert len(stats.aux) == len(stats.routed) == 1


def test_moe_no_grad_forward_leaves_nothing_for_the_next_step():
    _, _, model = _pair("CausalLM")
    twin = torch_tf.CausalLM(model.config)
    twin.load_state_dict(model.state_dict())
    ids = _ids(seed=6)
    batch = DataBatch(torch.from_numpy(ids[:, :-1]),
                      torch.from_numpy(ids[:, 1:]), torch.ones(4))
    with torch.no_grad():  # serving: outside any collect_moe block
        model(batch.x)
    with torch_tf.collect_moe() as stats:
        with torch.no_grad():
            model(batch.x)
    assert len(stats.aux) == 1
    m_served, g_served = _grads_and_stats(model, batch)
    m_fresh, g_fresh = _grads_and_stats(twin, batch)
    assert float(m_served.loss) == float(m_fresh.loss)
    for name, g in g_fresh.items():
        torch.testing.assert_close(g_served[name], g, rtol=0, atol=0)


@pytest.mark.parametrize("cf,check", [
    (0.05, lambda d: d > 0.3),
    (8.0, lambda d: d == 0.0),
])
def test_moe_drop_fraction_starved_and_ample(cf, check):
    # The JAX package's drop-fraction test: a starving capacity factor
    # drops most token-choices, an ample one none; the same fractions
    # as the JAX trainer's.
    jax_model, _, model = _pair("CausalLM", moe_top_k=2, capacity_factor=cf)
    ids = _ids(b=8, seed=0)
    x, y = ids[:, :-1], ids[:, 1:]
    kw = dict(criterion="cross_entropy", optimizer="sgd",
              optimizer_params={"lr": 1e-3})
    got = train_distributed(port.serialize_torch_obj(model, **kw), x,
                            labels=y, iters=1, device="cpu")
    want = jax_train(jax_pkg.serialize_torch_obj(jax_model, **kw), x,
                     labels=y, iters=1, seed=0,
                     mesh=build_mesh(devices=jax.devices()[:1]))
    drop = got.metrics[0]["moe_drop_fraction"]
    assert check(drop)
    assert drop == want.metrics[0]["moe_drop_fraction"]


def test_moe_classifier_fit_then_transform_matches_jax():
    # The estimator fits an MoE classifier and serves it through
    # ``transform`` (no example weights there, as in the JAX package).
    # The JAX estimator trains on its 8-device mesh, each shard routing
    # its own rows: groups of one row (16 tokens) route alike there and
    # in the port's one process.
    jax_model, _, model = _pair("SequenceClassifier", moe_top_k=2,
                                moe_group_size=16)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 128, (12, 16)).astype(np.float32)
    frame = {"features": list(ids),
             "label": rng.integers(0, 2, 12).astype(np.float32)}
    kw = dict(criterion="cross_entropy", optimizer="adam",
              optimizer_params={"lr": 1e-2})
    est_kw = dict(inputCol="features", labelCol="label", iters=3)
    jax_est = jax_pkg.SparkTorch(
        torchObj=jax_pkg.serialize_torch_obj(jax_model, **kw), **est_kw)
    est = port.SparkTorch(torchObj=port.serialize_torch_obj(model, **kw),
                          device="cpu", **est_kw)
    want = jax_est.fit(frame).transform(frame, {"useVectorOut": True})
    got = est.fit(frame).setDevice("cpu").transform(
        frame, {"useVectorOut": True})
    np.testing.assert_allclose([r["loss"] for r in est._last_metrics],
                               [r["loss"] for r in jax_est._last_metrics],
                               atol=1e-5, rtol=1e-5)
    assert all("moe_drop_fraction" in r for r in est._last_metrics)
    np.testing.assert_allclose(np.stack(got["predictions"]),
                               np.stack(want["predictions"]),
                               atol=1e-4, rtol=1e-4)


def test_moe_init_scale_and_ep_dispatch():
    # Flax's lecun_normal on the 3-D expert kernels takes a fan-in of
    # d·e (d_ff·e): std 1/sqrt(512·8) for (8, 512, 2048).
    cfg = torch_tf.TransformerConfig(d_model=512, d_ff=2048, n_experts=8)
    torch.manual_seed(0)
    layer = torch_tf.MoEFFN(cfg)
    assert float(layer.moe_w_in.detach().std()) == pytest.approx(
        1 / np.sqrt(512 * 8), rel=0.02)
    assert float(layer.moe_w_out.detach().std()) == pytest.approx(
        1 / np.sqrt(2048 * 8), rel=0.02)
    assert set(dict(layer.named_parameters())) == {
        "router.weight", "router.bias", "moe_w_in", "moe_b_in",
        "moe_w_out", "moe_b_out"}
    for mode in ("auto", "a2a", "replicate"):  # ep = 1: nothing to choose
        torch_tf.MoEFFN(torch_tf.TransformerConfig(
            **dict(MOE, moe_ep_dispatch=mode)))
    with pytest.raises(ValueError, match="moe_ep_dispatch"):
        torch_tf.MoEFFN(torch_tf.TransformerConfig(
            **dict(MOE, moe_ep_dispatch="ring")))
    # An MoE layer holds no dense FFN.
    lm = torch_tf.CausalLM(torch_tf.TransformerConfig(**MOE))
    names = [n for n, _ in lm.named_parameters()]
    assert not any(n.startswith("backbone.layers.1.mlp") for n in names)
    assert any(n.startswith("backbone.layers.0.mlp_in") for n in names)
