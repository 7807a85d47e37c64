"""SPK108 true negatives: the same readbacks inside a ledger span or a
step span, or annotated as a documented exception."""

import torch


def drain_metrics(ledger, goodput, loss, losses, stream):
    with goodput.span("data_wait", {"site": "drain"}):
        a = loss.item()
        torch.cuda.synchronize()
    with ledger.step_span(3):
        b = losses.cpu().tolist()
        stream.synchronize()
    c = losses.numpy()  # lint-obs: ok (fixture: end-of-run host copy)
    return a, b, c
