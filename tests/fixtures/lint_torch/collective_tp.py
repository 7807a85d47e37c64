"""SPK402 true positives: torch.distributed collectives that name no
group (or group=None) and so silently span the default WORLD group."""

import torch.distributed as dist
from torch import distributed
from torch.distributed import all_to_all_single


def sync_grads(flat, shards, out, parts):
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    dist.barrier()
    dist.broadcast(flat, src=0, group=None)
    distributed.send(flat, 1)
    all_to_all_single(out, flat)
    dist.all_gather(parts, flat, None)
