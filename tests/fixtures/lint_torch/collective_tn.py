"""SPK402 true negatives: every collective names its group — the
mesh axis's group, one passed in by the caller (the caller's
obligation), or positionally."""

import torch.distributed as dist


def sync_grads(flat, mesh, parts):
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.barrier(group=mesh.group)
    dist.all_gather(parts, flat, mesh.group)


def ring_step(buf, peer, group):
    req = dist.isend(buf, peer, group=group)
    dist.recv(buf, peer, group)
    return req
