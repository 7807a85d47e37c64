"""Profiling and tracing hooks over the telemetry bus — the port of ``sparktorch_tpu/utils/tracing.py``.

:func:`profile_run` captures a ``torch.profiler`` trace (CPU and, with
a card, CUDA activity) around a whole run and writes it into its
directory as a Chrome trace; :func:`step_annotation` marks each
dispatched step (or chunk of steps) as a ``train_step`` range in that
trace and, on a CUDA device, as an NVTX range. The bookkeeping is the
JAX package's: the ``tracing.profile_runs`` counter, the
``tracing.profile_s`` histogram (the capture's wall cost), the
``tracing.trace_url`` info value, the ``profile_trace`` event and the
``tracing.annotated_steps`` counter. With ``analyze`` (the default) a
finished capture is read by the trace analyzer
(:func:`~sparktorch_tpu_torch.obs.xprof.analyze_and_publish`), told how
many ``train_step`` ranges the bus counted during the capture.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch

from sparktorch_tpu_torch.obs import get_telemetry

TRACE_SUFFIX = ".pt.trace.json"


def trace_viewer_url(log_dir: str, host: str = "localhost",
                     port: int = 6006) -> str:
    """TensorBoard deep link for a captured trace: the profile plugin
    lists runs by the path fragment under the logdir, so the URL pins
    the run to the trace just written (``tensorboard --logdir <dir>``
    serves it)."""
    import urllib.parse

    run = os.path.basename(os.path.normpath(log_dir)) or "."
    return (f"http://{host}:{port}/#profile"
            f"&run={urllib.parse.quote(run, safe='')}")


@contextlib.contextmanager
def profile_run(log_dir: Optional[str], telemetry=None,
                analyze: bool = True) -> Iterator[dict]:
    """Profile the enclosed block when ``log_dir`` is set; no-op
    otherwise. The Chrome trace lands in ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` (the name TensorBoard's PyTorch
    profiler plugin reads; chrome://tracing and Perfetto open it too).

    Yields a handle dict: ``"trace_path"`` is the written file once the
    block exits (None when profiling is off), and ``"analysis"`` the
    :class:`~sparktorch_tpu_torch.obs.xprof.TraceAnalysis` of the
    capture, published onto the bus (None when ``analyze`` is off or
    the analysis failed: a torn capture bumps
    ``xprof.analyze_failures`` and never raises). The analyzer's
    truncation check compares the trace's ``train_step`` ranges with
    the ``tracing.annotated_steps`` counted during the capture."""
    handle: dict = {"analysis": None, "trace_path": None}
    if not log_dir:
        yield handle
        return
    tele = telemetry or get_telemetry()
    tele.counter("tracing.profile_runs")
    steps_before = tele.counter_value("tracing.annotated_steps")
    # Not a span: a span here would sit on the thread's span stack for
    # the whole run and re-path every trainer span under it, so metric
    # names would depend on whether profiling is on. A histogram
    # attributes the capture's wall cost instead.
    t0 = time.perf_counter()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield handle
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}."
                     f"{time.time_ns()}{TRACE_SUFFIX}")
        prof.export_chrome_trace(path)
        handle["trace_path"] = path
        # log_dir is not a label (label values are simple tokens; a path
        # may hold ',' and '='): the location travels on the event.
        tele.observe("tracing.profile_s", time.perf_counter() - t0)
        url = trace_viewer_url(log_dir)
        tele.info("tracing.trace_url", url)
        tele.event("profile_trace", log_dir=log_dir, trace_url=url,
                   view_cmd=f"tensorboard --logdir {log_dir}")
        if analyze:
            from sparktorch_tpu_torch.obs.xprof import analyze_and_publish

            expected = int(tele.counter_value("tracing.annotated_steps")
                           - steps_before)
            handle["analysis"] = analyze_and_publish(
                path, telemetry=tele,
                expected_steps=expected if expected > 0 else None)


@contextlib.contextmanager
def step_annotation(step: int, telemetry=None, device=None):
    """One ``train_step`` range in the trace around a dispatched step
    (or chunk of steps) numbered ``step``, and one count of
    ``tracing.annotated_steps`` on the bus. On a CUDA ``device`` the
    range is also an NVTX range, for tools that read NVTX; a CPU-only
    torch has no NVTX, so the CPU takes the profiler range alone."""
    (telemetry or get_telemetry()).counter("tracing.annotated_steps")
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function("train_step",
                                        args=f"step_num={int(step)}"):
        if nvtx:
            torch.cuda.nvtx.range_push(f"train_step {int(step)}")
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
