"""Host↔card copies off the device's current stream.

Every thread's work goes to the device's default stream unless it asks
for another, so a copy enqueued there waits behind whatever the other
threads of the process queued first: a serving replica's forward, a
worker's backward. A blocking copy of a model, one tensor at a time,
waits for that queue once per tensor. :func:`copy_stream` runs a
block's copies on a side stream that waits for the queue once, and
returns when they are done.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def copy_stream(device) -> Iterator[None]:
    """Run the block's work on a side stream of ``device`` and wait for
    it on exit, an exception included (the copies must land before
    their tensors can be freed). The side stream first waits for the
    work already queued on the caller's current stream, so the block
    reads what was written there and writes no memory that queued work
    still reads. Off CUDA, the block runs as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        side.synchronize()
