"""The streaming and checkpoint paths on the card.

Marked ``cuda``: every test skips where no CUDA device is present. It
imports only torch, numpy and the port, so it runs on a machine without
jax:

    python -m pytest --noconftest tests/test_torch_cuda_stream.py -q
"""

import numpy as np
import pytest
import torch
from torch import nn

from sparktorch_tpu_torch import BatchPredictor, inference
from sparktorch_tpu_torch.models import simple
from sparktorch_tpu_torch.train.sync import (
    _ChunkFeeder,
    train_distributed,
    train_distributed_streaming,
)
from sparktorch_tpu_torch.utils.checkpoint import CheckpointManager
from sparktorch_tpu_torch.utils.serde import ModelSpec, serialize_torch_obj


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SEEN = []


class _Recorder(nn.Module):
    """A linear model that keeps a host copy of every input it is given."""

    def __init__(self, width):
        super().__init__()
        self.Dense_0 = nn.Linear(width, 1)

    def forward(self, x):
        SEEN.append(x.detach().cpu().clone())
        return self.Dense_0(x)


@pytest.mark.cuda
def test_side_stream_upload_is_the_host_chunk(cuda_device):
    # Row i holds i + column / 1000; each chunk a step sees equals the
    # host chunk of the epoch's permutation, the last one's tail zero.
    n, rows, width, seed = 3 * 4096 + 100, 4096, 256, 3
    x = (np.arange(n)[:, None] + np.arange(width)[None] / 1000).astype(
        np.float32)
    y = np.zeros(n, np.float32)
    spec = ModelSpec(module=_Recorder(width), loss="mse", optimizer="sgd",
                     optimizer_params={"lr": 0.0}, input_shape=(width,))
    SEEN.clear()
    r = train_distributed_streaming(spec, x, labels=y, chunk_rows=rows,
                                    epochs=2, seed=seed, device=cuda_device)
    assert [m["examples"] for m in r.metrics] == [4096.0] * 3 + [100.0] + \
        [4096.0] * 3 + [100.0]
    rng = np.random.default_rng(seed + 1)
    want = []
    for _ in range(2):
        order = rng.permutation(n)
        for lo in range(0, n, rows):
            chunk = np.zeros((rows, width), np.float32)
            idx = order[lo:lo + rows]
            chunk[:len(idx)] = x[idx]
            want.append(chunk)
    assert len(SEEN) == len(want)
    for seen, chunk in zip(SEEN, want):
        np.testing.assert_array_equal(seen.numpy(), chunk)


@pytest.mark.cuda
def test_chunk_feeder_copies_on_a_side_stream(cuda_device):
    x = np.random.default_rng(0).standard_normal((64, 1024)).astype(np.float32)
    y = np.arange(64)
    w = np.ones(64, np.float32)
    feeder = _ChunkFeeder([x, y, w], 48, cuda_device)
    assert feeder.stream != torch.cuda.current_stream(cuda_device)
    idx = np.arange(63, -1, -4)  # 16 rows, reversed: 32 padding rows
    for _ in range(3):  # both staging buffers, then the first again
        batch = feeder.take(feeder.put(idx))
        assert all(t.device.type == "cuda" for t in batch)
        torch.testing.assert_close(batch[0][:16].cpu(),
                                   torch.from_numpy(x[idx]), atol=0, rtol=0)
        assert float(batch.x[16:].abs().sum()) == 0.0
        assert batch.y[:16].tolist() == idx.tolist()
        assert batch.w.sum().item() == 16.0


@pytest.mark.cuda
@pytest.mark.parametrize("in_flight", [2, 4])
def test_predict_device_backpressure(cuda_device, monkeypatch, in_flight):
    torch.manual_seed(0)
    module = simple.MnistMLP(hidden=(64,), n_classes=10, in_features=256)
    pred = BatchPredictor(module, device=cuda_device, chunk=32,
                          preprocess=lambda t: t.float() / 255,
                          postprocess=lambda y: y.argmax(-1))
    raw = np.random.default_rng(1).integers(0, 256, (300, 256),
                                            dtype=np.uint8)
    waits = []
    real = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: (waits.append(1), real(self))[1])
    out = pred.predict_device(raw, in_flight=in_flight)
    n_chunks = -(-300 // 32)
    assert len(waits) == n_chunks - in_flight + 1
    assert out.device.type == "cuda" and out.shape == (300,)
    monkeypatch.undo()
    torch.testing.assert_close(out.cpu(), torch.from_numpy(pred.predict(raw)))
    # A tensor already on the card is not copied, and gives the same rows.
    dev = torch.from_numpy(raw).to(cuda_device)
    np.testing.assert_array_equal(pred.predict(dev), pred.predict(raw))


@pytest.mark.cuda
def test_stream_parquet_predict_on_the_card(cuda_device, tmp_path):
    pytest.importorskip("pyarrow")
    torch.manual_seed(0)
    module = simple.MnistMLP(hidden=(64,), n_classes=10, in_features=256)
    pred = BatchPredictor(module, device=cuda_device, chunk=64,
                          preprocess=lambda t: t.float() / 255)
    raw = np.random.default_rng(2).integers(0, 256, (500, 256),
                                            dtype=np.uint8)
    path = str(tmp_path / "rows.parquet")
    inference.write_rows_parquet(path, [raw], rows_per_group=64)
    want = pred.predict(raw)
    for device_outputs in (False, True):
        outs = []
        stats = inference.stream_parquet_predict(
            pred, path, row_shape=(256,), drain=outs.append,
            device_outputs=device_outputs, skip_rows=10, max_rows=400)
        got = (torch.cat(outs).cpu().numpy() if device_outputs
               else np.concatenate(outs))
        assert stats["n_rows"] == 400
        np.testing.assert_allclose(got, want[10:410], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_checkpoint_of_a_cuda_state(cuda_device, tmp_path):
    torch.manual_seed(0)
    obj = serialize_torch_obj(simple.Net(), criterion="mse", optimizer="adam",
                              optimizer_params={"lr": 1e-2},
                              input_shape=(10,))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (64, 10)).astype(np.float32)
    y = (x.mean(1) > 0).astype(np.float32)
    kw = dict(labels=y, steps_per_call=1, seed=7, device=cuda_device)
    straight = train_distributed(obj, x, iters=5, **kw)
    d = str(tmp_path / "ckpt")
    train_distributed(obj, x, iters=3, checkpoint_dir=d, **kw)
    # The snapshot holds CPU tensors only: it loads with no card.
    state = torch.load(f"{d}/3/state.pt", weights_only=True)
    tensors = list(state["model"].values()) + [
        v for s in state["optimizer"]["state"].values() for v in s.values()]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    assert state["step"] == 3
    resumed = train_distributed(obj, x, iters=2, checkpoint_dir=d,
                                resume=True, **kw)
    assert CheckpointManager(d).all_steps() == [3, 5]
    for key, value in straight.params.items():
        torch.testing.assert_close(resumed.params[key], value, atol=0,
                                   rtol=0, msg=key)
