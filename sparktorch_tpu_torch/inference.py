"""Batch inference over already-trained models — the port of ``sparktorch_tpu/inference.py``.

A "trained model" here is a torch module holding its weights (or a
module plus a ``state_dict`` to load). :class:`BatchPredictor` runs it
in fixed-size chunks under ``torch.inference_mode()`` on an explicit
device: CUDA unless the caller passes ``device="cpu"``. Optional
``preprocess``/``postprocess`` callables run on the device inside that
forward, so raw uint8 pixels can cross the bus and an argmax can shrink
the read-back. :func:`write_rows_parquet` and
:func:`stream_parquet_predict` are the Parquet streaming path of
BASELINE config 5 (pyarrow is imported inside them only).

Serving metrics land on the telemetry bus under the JAX package's
names: ``inference.batch_fill`` (real rows over each chunk's rows),
``inference.predict_s``, ``inference.requests`` and ``inference.rows``,
labelled ``path=host`` (``predict``) or ``path=device``
(``predict_device``).
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from sparktorch_tpu_torch.ml.estimator import SparkTorchModel, _encode_bundle
from sparktorch_tpu_torch.ml.pipeline import PipelineModel
from sparktorch_tpu_torch.obs import get_telemetry
from sparktorch_tpu_torch.utils.serde import ModelSpec, meta_copy
from sparktorch_tpu_torch.utils.streams import copy_stream


def _resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is asked for (or
    left to the default) and there is no card. The port never falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class BatchPredictor:
    """Chunked batch inference on one device, or sharded over a mesh.

    Every forward sees one input shape: rows go in ``chunk``-row
    pieces, and when there is more than one chunk the last is
    zero-padded to ``chunk`` rows (the padding is cut from the output).
    With a ``mesh`` of n > 1 batch shards (dp × fsdp), every rank calls
    ``predict`` with the same rows: the chunk is rounded up to a
    multiple of n (a lone short chunk pads to one), each rank runs the
    forward on its contiguous n-th of every chunk, and one
    ``all_gather`` gives every rank all the rows, in order — as the JAX
    package's sharded forward returns them. A mesh of one makes no
    collective.
    On CUDA the host→device copy of chunk i+1 is enqueued from pinned
    memory before chunk i's result is read back, so the copy overlaps
    the readback; device memory holds about two chunks. Input already on
    the device is not copied.
    """

    def __init__(self, module: torch.nn.Module,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, chunk: int = 1024,
                 preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None, mesh=None,
                 telemetry=None):
        """``params`` (optional) is a ``state_dict`` to load into
        ``module`` first (buffers included: torch has no separate
        model state). ``preprocess`` maps each device chunk before the
        module (e.g. ``lambda x: x.float() / 255`` on uint8 pixels: a
        quarter of float32's host→device bytes); ``postprocess`` maps
        the module's output (e.g. ``lambda y: y.argmax(-1)``: one value
        a row read back instead of the logits). ``mesh``: a
        :func:`~sparktorch_tpu_torch.parallel.mesh.build_mesh` mesh.
        ``telemetry``: the bus the ``inference.*`` metrics land on (the
        process-global one by default)."""
        self.device = _resolve_device(device)
        self.telemetry = telemetry or get_telemetry()
        if params is not None:
            module.load_state_dict(params)
        self.module = module.to(self.device).eval()
        self.mesh = mesh
        self._shards = mesh.batch_shards if mesh is not None else 1
        c = max(1, int(chunk), self._shards)
        self.chunk = -(-c // self._shards) * self._shards
        self.preprocess = preprocess
        self.postprocess = postprocess

    def update_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Serve new weights (a ``state_dict``, buffers included). They
        are loaded into a fresh device copy of the module, which is then
        installed by one attribute assignment: a concurrent ``predict``
        chunk runs on the old or the new weights whole, never a mix. The
        load's copies run off the device's current stream, where a
        concurrent ``predict`` queues its work (:func:`copy_stream`)."""
        fresh = copy.deepcopy(self.module)
        with copy_stream(self.device):
            fresh.load_state_dict(params)
        self.module = fresh.eval()

    def _chunks(self, x, n: int):
        """Yield (padded_part, real_rows) chunks of one shape (a lone
        short chunk pads only to a multiple of the mesh's batch shards)."""
        for start in range(0, n, self.chunk):
            part = x[start : start + self.chunk]
            real = part.shape[0]
            target = (self.chunk if n > self.chunk
                      else -(-real // self._shards) * self._shards)
            if real < target:
                if isinstance(part, torch.Tensor):
                    pad = part.new_zeros((target - real, *part.shape[1:]))
                    part = torch.cat([part, pad])
                else:
                    pad = np.zeros((target - real, *part.shape[1:]),
                                   part.dtype)
                    part = np.concatenate([part, pad])
            self.telemetry.observe("inference.batch_fill",
                                   real / max(1, part.shape[0]))
            yield part, real

    def _put(self, part) -> torch.Tensor:
        """This rank's share of a chunk, on the device."""
        if self._shards > 1:
            per = part.shape[0] // self._shards
            i = self.mesh.batch_index  # tp peers take the same rows
            part = part[i * per:(i + 1) * per]
        if isinstance(part, torch.Tensor):
            if part.device.type != "cpu":
                return part.to(self.device)  # on the card already
            t = part
        else:
            t = torch.from_numpy(np.ascontiguousarray(part))
        if self.device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)
        return t.to(self.device)

    def _fwd(self, x: torch.Tensor,
             module: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """The forward of ``module`` (this predictor's by default) on a
        device chunk, with the pre- and postprocessing."""
        if module is None:
            module = self.module  # one read: old or new weights, whole
        with torch.inference_mode():
            if self.preprocess is not None:
                x = self.preprocess(x)
            out = module(x)
            if self.postprocess is not None:
                out = self.postprocess(out)
            if self._shards > 1:
                out = out.contiguous()
                parts = [torch.empty_like(out) for _ in range(self._shards)]
                dist.all_gather(parts, out, group=self.mesh.batch_group)
                out = torch.cat(parts)
            return out

    def _probe(self, x) -> torch.Tensor:
        """The output of one zero row a rank, for the shape of an empty
        result."""
        shape = (self._shards, *x.shape[1:])
        if isinstance(x, torch.Tensor):
            probe = x.new_zeros(shape)
        else:
            probe = np.zeros(shape, x.dtype)
        return self._fwd(self._put(probe))[:0]

    def predict(self, x) -> np.ndarray:
        """Chunked forward over the rows of ``x`` (numpy, or a tensor:
        one already on the device skips the upload)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        n = x.shape[0]
        if n == 0:
            return self._probe(x).cpu().numpy()
        t0 = time.perf_counter()
        parts = self._chunks(x, n)
        host = []
        nxt = next(parts)
        dev = self._put(nxt[0])
        prev = None  # (device_out, real) one chunk behind
        while nxt is not None:
            _, real = nxt
            out = self._fwd(dev)
            nxt = next(parts, None)
            if nxt is not None:
                dev = self._put(nxt[0])  # queued before the readback below
            if prev is not None:
                host.append(prev[0].cpu().numpy()[: prev[1]])
            prev = (out, real)
        host.append(prev[0].cpu().numpy()[: prev[1]])
        out = np.concatenate(host) if len(host) > 1 else host[0]
        # The read-backs above waited for the card, so this covers the
        # copies and the compute.
        self._record("host", time.perf_counter() - t0, n)
        return out

    def _record(self, path: str, seconds: float, rows: int) -> None:
        tele = self.telemetry
        tele.observe("inference.predict_s", seconds, labels={"path": path})
        tele.counter("inference.requests", labels={"path": path})
        tele.counter("inference.rows", float(rows), labels={"path": path})

    def predict_device(self, x, in_flight: int = 3) -> torch.Tensor:
        """Chunked forward with no device→host read-back: returns ONE
        device tensor of predictions (padding cut), leaving the download
        and so the sync cadence to the caller. Backpressure: once
        ``in_flight`` chunks are queued, the host waits on the event of
        the oldest before it queues another, which bounds the live input
        buffers."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        n = x.shape[0]
        if n == 0:
            return self._probe(x)
        t0 = time.perf_counter()
        outs, pending = [], []
        for part, real in self._chunks(x, n):
            out = self._fwd(self._put(part))
            outs.append(out[:real])
            if self.device.type == "cuda":
                pending.append(torch.cuda.current_stream(
                    self.device).record_event())
                if len(pending) >= max(2, in_flight):
                    pending.pop(0).synchronize()
        # Enqueue time only: this path never waits for the last chunk.
        self._record("device", time.perf_counter() - t0, n)
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def predict_stream(self, batches: Iterable) -> Iterator[np.ndarray]:
        """Predictions per batch of a stream of batches (e.g. Parquet
        row groups)."""
        for batch in batches:
            yield self.predict(batch)


def write_rows_parquet(path: str, rows: Iterable[np.ndarray],
                       column: str = "features",
                       rows_per_group: int = 1024) -> int:
    """Write row batches (each an (n, ...) array of one fixed dtype) to
    a Parquet file as raw fixed-size binary, uncompressed — the file the
    JAX package's ``write_rows_parquet`` writes. Returns the rows
    written."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    writer = None
    total = 0
    try:
        for batch in rows:
            batch = np.ascontiguousarray(batch)
            n = batch.shape[0]
            nbytes = batch[0].nbytes if n else 0
            arr = pa.FixedSizeBinaryArray.from_buffers(
                pa.binary(nbytes), n,
                [None, pa.py_buffer(batch.tobytes())],
            )
            table = pa.table({column: arr})
            if writer is None:
                writer = pq.ParquetWriter(path, table.schema,
                                          compression="NONE")
            writer.write_table(table, row_group_size=rows_per_group)
            total += n
    finally:
        if writer is not None:
            writer.close()
    return total


def parquet_batches(path: str, row_shape, dtype=np.uint8,
                    column: str = "features", batch_rows: int = 1024,
                    skip_rows: int = 0,
                    max_rows: Optional[int] = None) -> Iterator[np.ndarray]:
    """The rows of a fixed-size-binary Parquet column as (n, *row_shape)
    arrays of ``dtype``, one per record batch, after dropping the first
    ``skip_rows`` rows and ending after ``max_rows`` (both cut inside a
    record batch where they fall there). The arrays are read-only views
    of Arrow's buffers."""
    import pyarrow.parquet as pq

    row_elems = int(np.prod(row_shape))
    itemsize = np.dtype(dtype).itemsize
    it = pq.ParquetFile(path).iter_batches(batch_size=batch_rows,
                                           columns=[column])
    to_skip = max(0, int(skip_rows))
    budget = max_rows if max_rows is not None else float("inf")
    for rb in it:
        if budget <= 0:
            return
        col = rb.column(0)
        if to_skip >= len(col):
            to_skip -= len(col)
            continue
        arr = np.frombuffer(
            col.buffers()[-1], dtype=dtype, count=len(col) * row_elems,
            offset=col.offset * row_elems * itemsize,
        ).reshape(len(col), *row_shape)
        arr = arr[to_skip:]
        to_skip = 0
        if arr.shape[0] > budget:
            arr = arr[: int(budget)]
        budget -= arr.shape[0]
        yield arr


def _stream_predict(predictor: BatchPredictor, batches: Iterator,
                    drain=None, prefetch: int = 2,
                    device_outputs: bool = False) -> dict:
    """Reader thread → bounded queue → predictor. The reader pulls each
    batch from ``batches`` (disk reads and decoding happen in that pull)
    and, for a CUDA predictor, copies it into page-locked memory, so the
    main thread's upload starts at once; the main thread feeds the
    predictor. A reader error is raised here after the reader ends; the
    end of the stream is the reader's sentinel, or the reader found dead
    with the queue empty (no sentinel needed)."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    reader_err: list = []
    read_busy = [0.0]
    pin = predictor.device.type == "cuda"

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                arr = next(batches, None)
                if arr is None:
                    read_busy[0] += time.perf_counter() - t0
                    return
                if pin:
                    staged = torch.empty(arr.shape, pin_memory=True,
                                         dtype=torch_dtype(arr.dtype))
                    staged.numpy()[...] = arr
                    arr = staged
                read_busy[0] += time.perf_counter() - t0
                if not _put(arr):
                    return
        except Exception as e:  # raised by the consumer below
            reader_err.append(e)
        finally:
            # Best-effort sentinel; the consumer does not rely on it.
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.25)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=reader, daemon=True)
    t_start = time.perf_counter()
    t.start()
    n_rows = n_batches = 0
    predict_busy = 0.0
    try:
        while True:
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                # A dead reader with an empty queue ends the stream; only
                # an empty queue seen AFTER it was found dead counts, so
                # nothing it enqueued before dying is lost.
                if t.is_alive():
                    continue
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
            if item is None:
                break
            t0 = time.perf_counter()
            out = (predictor.predict_device(item) if device_outputs
                   else predictor.predict(item))
            predict_busy += time.perf_counter() - t0
            assert out.shape[0] == item.shape[0]
            if drain is not None:
                drain(out)
            n_rows += item.shape[0]
            n_batches += 1
    finally:
        stop.set()
        t.join(timeout=30)
    if reader_err:
        raise reader_err[0]
    wall = time.perf_counter() - t_start
    return {
        "n_rows": n_rows,
        "n_batches": n_batches,
        "wall_s": round(wall, 3),
        "rows_per_sec": round(n_rows / max(wall, 1e-9), 2),
        "read_busy_s": round(read_busy[0], 3),
        "predict_busy_s": round(predict_busy, 3),
        # > 1.0: the stages overlapped (wall below their sum).
        "overlap_factor": round(
            (read_busy[0] + predict_busy) / max(wall, 1e-9), 3),
    }


def stream_parquet_predict(
    predictor: BatchPredictor,
    path: str,
    row_shape,
    dtype=np.uint8,
    column: str = "features",
    batch_rows: Optional[int] = None,
    drain=None,
    prefetch: int = 2,
    skip_rows: int = 0,
    max_rows: Optional[int] = None,
    device_outputs: bool = False,
) -> dict:
    """Parquet → device streaming inference (BASELINE config 5's path):
    a reader thread decodes the fixed-size-binary column into
    (n, *row_shape) arrays of the raw column dtype (see
    :func:`parquet_batches` for the ``skip_rows``/``max_rows`` window)
    and fills a bounded queue; the main thread feeds ``predictor``.

    ``drain`` receives each batch's predictions (numpy; device tensors
    with ``device_outputs=True``, which runs ``predict_device`` and
    reads nothing back inside the stream — ``predict_busy_s`` then
    measures dispatch). Returns the stats ``n_rows``, ``n_batches``,
    ``wall_s``, ``rows_per_sec``, ``read_busy_s``, ``predict_busy_s``
    and ``overlap_factor`` (read + predict busy over wall: above 1 the
    stages overlapped)."""
    batches = parquet_batches(path, row_shape, dtype, column,
                              batch_rows or predictor.chunk, skip_rows,
                              max_rows)
    return _stream_predict(predictor, batches, drain, prefetch,
                           device_outputs)


def convert_to_serialized(
        model: torch.nn.Module,
        variables: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Serialize a trained module to the model string format used by
    :class:`SparkTorchModel`: a weight-free copy of the module plus a
    ``state_dict`` (``variables`` if given, else the module's own)."""
    if variables is None:
        variables = model.state_dict()
    params = {k: v.detach().cpu() for k, v in dict(variables).items()}
    return _encode_bundle(ModelSpec(module=meta_copy(model)), params)


def create_spark_torch_model(
    model: torch.nn.Module,
    variables: Optional[Mapping[str, torch.Tensor]] = None,
    inputCol: str = "features",
    predictionCol: str = "predicted",
    useVectorOut: bool = False,
) -> SparkTorchModel:
    """Wrap a trained module as a transformer without running ``fit``."""
    return SparkTorchModel(
        inputCol=inputCol,
        predictionCol=predictionCol,
        modStr=convert_to_serialized(model, variables),
        useVectorOut=useVectorOut,
    )


def attach_model_to_pipeline(
    pipeline_model: PipelineModel,
    spark_model: SparkTorchModel,
) -> PipelineModel:
    """Append an inference stage to a fitted pipeline."""
    return PipelineModel(list(pipeline_model.stages) + [spark_model])


# Reference-compatible name.
attach_pytorch_model_to_pipeline = attach_model_to_pipeline
