"""SPK401 true positives — the recompile-tax class under torch.compile:
a compiled callable fed len()/loop-index Python scalars, and a compiled
function closing over a mutated module global."""

import torch

_RUNTIME_FLAGS = {"scale": 1.0}


def configure(scale):
    _RUNTIME_FLAGS["scale"] = scale


@torch.compile
def scaled_loss(x):
    return x * _RUNTIME_FLAGS["scale"]


def train(step_fn, batches):
    step = torch.compile(step_fn)
    out = None
    for i in range(len(batches)):
        out = step(batches[i], i)
    for j, batch in enumerate(batches):
        out = step(batch, offset=j)
    return step(out, len(batches))
