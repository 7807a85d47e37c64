"""SPK108 true positives: raw device readbacks a trainer would do
outside any ledger span — each one waits for the card and hides the
wait from the goodput accounting."""

import torch
from torch.cuda import synchronize as sync


def drain_metrics(loss, losses, stream, event):
    a = loss.item()
    b = losses.cpu()
    c = losses.tolist()
    d = losses.detach().numpy()
    torch.cuda.synchronize()
    sync()
    stream.synchronize()
    event.synchronize()
    return a, b, c, d
