"""The parameter server in both packages: applies, pulls, votes, errors.

Both servers start from the parameters the JAX server initialises for
its seed (carried into the port's module by ``convert``), and take the
same fixed sequence of gradient trees.
"""

import http.client
import time

import jax
import ml_dtypes
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparktorch_tpu as jax_pkg
import sparktorch_tpu_torch as port
from sparktorch_tpu.models import resnet as jax_resnet
from sparktorch_tpu.serve import param_server as jax_ps
from sparktorch_tpu_torch.convert import state_dict_from_flax
from sparktorch_tpu_torch.models import resnet
from sparktorch_tpu_torch.serve import param_server as ps

SHAPE = (8, 8, 3)


def _pair(optimizer, params, seed=0):
    jax_model = jax_resnet.resnet18(num_classes=3, width=4,
                                    compute_dtype=jnp.float32)
    variables = jax.device_get(jax_model.init(jax.random.key(seed),
                                              jnp.zeros((1, *SHAPE))))
    module = resnet.resnet18(num_classes=3, width=4, compute_dtype="float32")
    module.load_state_dict(state_dict_from_flax(variables, module))
    kw = dict(criterion="cross_entropy", optimizer=optimizer,
              optimizer_params=params, input_shape=SHAPE)
    return (jax_pkg.serialize_torch_obj(jax_model, **kw),
            port.serialize_torch_obj(module, **kw), variables, module)


def _to_port(tree, variables, module):
    """A Flax-layout params tree in the port's names and layouts."""
    full = state_dict_from_flax(
        {"params": tree, "batch_stats": variables["batch_stats"]}, module)
    return {n: full[n] for n, _ in module.named_parameters()}


def _grads(variables, rng):
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])


@pytest.mark.parametrize("optimizer,params,tol", [
    ("sgd", {"lr": 0.1}, 2e-5),
    ("sgd", {"lr": 0.05, "momentum": 0.9}, 2e-5),
    ("adam", {"lr": 1e-2}, 1e-4),
])
def test_same_gradients_give_the_same_parameters(optimizer, params, tol):
    jax_obj, obj, variables, module = _pair(optimizer, params)
    want_server = jax_ps.ParameterServer(jax_obj, seed=0)
    server = ps.ParameterServer(obj, device="cpu", seed=0)
    try:
        rng = np.random.default_rng(1)
        for step in range(4):
            g = _grads(variables, rng)
            port_g = _to_port(g, variables, module)
            if step % 2:
                # Every other push in bfloat16, as a compressed wire
                # sends it; both servers cast it up before the update.
                g = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), g)
                port_g = {k: v.to(torch.bfloat16) for k, v in port_g.items()}
            want_server.push_gradients(g)
            server.push_gradients(port_g)
        want_params, want_state = want_server.final_state()
        got_params, got_state = server.final_state()
        assert server.applied_updates == want_server.applied_updates == 4
    finally:
        want_server.stop()
        server.stop()
    want = _to_port(jax.device_get(want_params), variables, module)
    assert list(got_params) == list(want)
    for key, value in got_params.items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   atol=tol, rtol=tol, err_msg=key)
    for key, value in got_state.items():
        np.testing.assert_array_equal(value.numpy(),
                                      module.state_dict()[key].numpy())


def test_bf16_pushes_are_cast_up_before_the_update():
    _, obj, variables, module = _pair("adam", {"lr": 1e-2})
    server = ps.ParameterServer(obj, device="cpu")
    twin = ps.ParameterServer(obj, device="cpu")
    try:
        g = _to_port(_grads(variables, np.random.default_rng(2)),
                     variables, module)
        server.push_gradients({k: v.to(torch.bfloat16) for k, v in g.items()})
        twin.push_gradients({k: v.to(torch.bfloat16).float()
                             for k, v in g.items()})
        for a, b in zip(server.final_state()[0].values(),
                        twin.final_state()[0].values()):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    finally:
        server.stop()
        twin.stop()


def test_pull_at_the_current_version_returns_none():
    _, obj, variables, module = _pair("sgd", {"lr": 0.1})
    server = ps.ParameterServer(obj, device="cpu")
    try:
        version, params = server.get_parameters(-1)
        assert version == 0 and server.get_parameters(version) is None
        server.push_gradients(_to_port(_grads(variables,
                                              np.random.default_rng(3)),
                                       variables, module))
        newer, fresh = server.get_parameters(version)
        assert newer == 1 and server.get_parameters(newer) is None
        # The old snapshot was not touched by the apply.
        for n, p in module.named_parameters():
            torch.testing.assert_close(params[n], p.detach(), atol=0, rtol=0)
        assert any(not torch.equal(fresh[n], params[n]) for n in params)
    finally:
        server.stop()


@pytest.mark.parametrize("losses,window,patience", [
    ([1.0, 0.9, 0.8, 0.85, 0.9, 0.95, 0.9, 0.92, 0.97, 1.0, 1.1, 1.2],
     3, 2),
    ([1.0, 0.8, 0.6, 0.4, 0.2, 0.1], 2, 1),
    ([2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0], 1, 3),
])
def test_windowed_early_stop_votes_as_jax(losses, window, patience):
    jax_obj, obj, _, _ = _pair("sgd", {"lr": 0.1})
    want_server = jax_ps.ParameterServer(jax_obj, window_len=window,
                                         early_stop_patience=patience)
    server = ps.ParameterServer(obj, window_len=window,
                                early_stop_patience=patience, device="cpu")
    try:
        want = [want_server.post_loss(x) for x in losses]
        got = [server.post_loss(x) for x in losses]
    finally:
        want_server.stop()
        server.stop()
    assert got == want


def test_error_budget_trips_after_max_tolerated_errors():
    _, obj, _, _ = _pair("sgd", {"lr": 0.1})
    server = ps.ParameterServer(obj, device="cpu")
    try:
        for _ in range(ps.MAX_TOLERATED_ERRORS):
            server.push_gradients({"no.such.param": torch.zeros(1)})
        assert server._failed is None
        server.push_gradients({"no.such.param": torch.zeros(1)})
        with pytest.raises(RuntimeError, match="parameter server failed"):
            server.push_gradients({})
        with pytest.raises(RuntimeError, match="parameter server failed"):
            server.final_state()
    finally:
        server.stop()


def _get(url_port, path, have):
    conn = http.client.HTTPConnection("127.0.0.1", url_port, timeout=10)
    conn.request("GET", path, headers={"X-Have-Version": str(have)})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def test_http_pulls_answer_not_modified_when_current():
    _, obj, variables, module = _pair("sgd", {"lr": 0.1})
    server = ps.ParameterServer(obj, device="cpu")
    front = ps.ParamServerHttp(server, port=0).start()
    try:
        status, body = _get(front.port, "/parameters.bin", -1)
        assert status == 200
        version, tree = ps.binwire.decode(body)
        assert version == 0
        assert set(tree) == {n for n, _ in module.named_parameters()}
        assert _get(front.port, "/parameters.bin", 0)[0] == 304
        assert _get(front.port, "/parameters", 0)[0] == 204
        server.push_gradients(_to_port(_grads(variables,
                                              np.random.default_rng(4)),
                                       variables, module))
        assert _get(front.port, "/parameters.bin", 0)[0] == 200
        assert _get(front.port, "/", 0)[0] == 200
        assert _get(front.port, "/nope", 0)[0] == 404
        conn = http.client.HTTPConnection("127.0.0.1", front.port, timeout=10)
        conn.request("POST", "/update.bin", body=b"not a frame")
        assert conn.getresponse().status == 400
        conn.close()
        time.sleep(0.05)
        assert server._errors == 0
    finally:
        front.stop()
        server.stop()
