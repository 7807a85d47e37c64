"""SPK401 true negatives: a compiled callable declared dynamic, scalars
passed as tensors, and a compiled function over an immutable global."""

import torch

SCALE = 2.0
_TABLE = {"scale": 1.0}


@torch.compile
def scaled(x):
    return x * SCALE


def train(step_fn, batches):
    step = torch.compile(step_fn, dynamic=True)
    fixed = torch.compile(step_fn)
    out = None
    for i in range(len(batches)):
        out = step(batches[i], i)
        out = fixed(batches[i], torch.tensor(i))
    return scaled(out) * _TABLE["scale"]
