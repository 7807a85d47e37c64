#!/usr/bin/env python3
"""Time ``TrainHealthLedger.note_step`` and its pieces, and the skew stamp, on one CUDA device.

    python3 health_costs.py [--root DIR] [--calls N] [--batches B]
                            [--reps R] [--block-s S] [--profile]
                            [--stamp-batches B] [--stamp-per-batch N]

Imports the port from ``--root`` (default: this checkout; give an
unpacked older tree to compare, and run older, newer, newer, older in
one call).

``pieces``: each of the ledger's pieces called ``--calls`` times in each
of ``--batches`` batches on a 0-d float32 CUDA tensor that is already
computed, as the min and the median of the batch means, in microseconds
a call: the ledger's lock, a note's two ``dict`` copies, a goodput
``data_wait`` span, the delayed read (``_read_device``), a row's ingest
and the throttled ``publish()``; and ``settle``, the ledger's work
every ``READ_BATCH`` notes (a merged read of that many and their
ingest), timed alone.

``after_step``: the bench ``health`` A/A's reading, each step a 768x768
matmul chain (two operands, alternating) synchronised and then noted:
``--reps`` interleaved triples of ``--block-s`` blocks (ledger off, on,
off again, in rotating order), every note timed. Reports the notes' min, median and mean, the mean
note over the off arm's mean step, and the A/A wall delta (the mean over
triples of the on block's mean step minus the same triple's off block's)
beside the off/off delta measured the same way, the collector's
pauses inside the notes; and, as the floor of any call there, a method
that does nothing called the same way. ``--profile`` also runs the on
arm's notes under ``cProfile`` and reports the functions that take the
most of their time (its own cost inflates every number of that run).

``skew_stamp_after_step``: the goodput ledger's skew stamp
(``StepSkewRing.record``) as a trainer pays it, ``--stamp-batches``
batches of ``--stamp-per-batch`` stamps, each batch right after one of
those steps, synchronised: the mean of all of them, the least and the
most batch mean, and the mean over the off arm's mean step.
Prints one JSON line with the card's name and power limit.
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time


def _per_call_us(fn, calls: int, batches: int) -> dict:
    for _ in range(min(calls, 200)):
        fn()
    means = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) / calls * 1e6)
    return {"min_us": min(means), "median_us": statistics.median(means)}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--batches", type=int, default=5)
    parser.add_argument("--reps", type=int, default=24)
    parser.add_argument("--block-s", type=float, default=0.05)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--stamp-batches", type=int, default=64)
    parser.add_argument("--stamp-per-batch", type=int, default=8)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("health_costs: no CUDA device", file=sys.stderr)
        return 1
    import sparktorch_tpu_torch
    from sparktorch_tpu_torch.obs import goodput as _goodput
    from sparktorch_tpu_torch.obs import health as _health
    from sparktorch_tpu_torch.obs.telemetry import Telemetry

    if not sparktorch_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {sparktorch_tpu_torch.__file__}, not "
                           f"the tree under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    n, b = args.calls, args.batches
    t = torch.ones((), device=dev) * 1.5
    torch.cuda.synchronize()

    def ledger():
        return _health.TrainHealthLedger(
            rank="hc", telemetry=Telemetry(run_id="health_costs"))

    out = {}
    led = ledger()
    out["lock"] = _per_call_us(lambda: led._lock.__enter__()
                               or led._lock.__exit__(None, None, None),
                               n, b)
    dev_vals, host_vals = {"loss": t}, {}
    out["dict_copies"] = _per_call_us(
        lambda: (dict(dev_vals or {}), dict(host_vals or {})), n, b)

    def span():
        with _goodput.span("data_wait", {"site": _health.GOODPUT_SITE}):
            pass

    out["span"] = _per_call_us(span, n, b)
    out["read_device"] = _per_call_us(
        lambda: _health._read_device(dev_vals), n, b)
    fetched = {"loss": np.asarray(1.5, np.float32)}
    step = [0]

    def ingest():
        step[0] += 1
        led._ingest_row(step[0], 1, 0, fetched)

    out["ingest_row"] = _per_call_us(ingest, n, b)
    led.publish(force=True)
    out["publish_throttled"] = _per_call_us(led.publish, n, b)
    if hasattr(_health, "READ_BATCH"):
        # A settle of READ_BATCH notes, the ledger's every-8th-note
        # work: the notes land untimed, then the settle (numbering, one
        # merged read of what fell due, the ingest) is timed alone.
        led_b = ledger()
        led_b.note_step(device=dev_vals)
        settles = []
        for _ in range(max(1, n // 10)):
            for _ in range(_health.READ_BATCH):
                led_b._inbox.append((None, 1, dict(dev_vals), {}))
            t0 = time.perf_counter()
            with led_b._lock:
                led_b._settle_locked()
            settles.append((time.perf_counter() - t0) * 1e6)
        out["settle"] = {"min_us": min(settles),
                         "median_us": statistics.median(settles)}

    # The A/A reading: note_step right after each step's sync.
    # Two operands of one shape, alternating, as the bench's A/A takes
    # them (one constant loss would be a plateau to the ledger).
    m = 768
    operands = [torch.ones((m, m), device=dev) * scale
                for scale in (1.0, 1.001)]
    turn = [0]

    def aa_step():
        turn[0] += 1
        a = x = operands[turn[0] % 2]
        for _ in range(4):
            x = (x @ a) * (1.0 / m)
        return (x.sum() / x.numel()).float()

    aa_step()
    torch.cuda.synchronize()
    led_s = ledger()
    # The interpreter's cyclic collector: its pauses inside notes.
    gc_s = [0.0, 0]
    gc_t0 = [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]
            gc_s[1] += 1

    prof = None
    if args.profile:
        import cProfile

        prof = cProfile.Profile()
    arms = ("off", "on", "off2")
    means = {arm: [] for arm in arms}
    notes = []
    for r in range(args.reps):
        for arm in arms[r % 3:] + arms[:r % 3]:
            walls = []
            t_end = time.perf_counter() + args.block_s
            while True:
                t0 = time.perf_counter()
                mean = aa_step()
                torch.cuda.synchronize()
                if arm == "on":
                    t1 = time.perf_counter()
                    gc.callbacks.append(on_gc)
                    if prof is not None:
                        prof.enable()
                    led_s.note_step(device={"loss": mean})
                    if prof is not None:
                        prof.disable()
                    gc.callbacks.remove(on_gc)
                    notes.append(time.perf_counter() - t1)
                t2 = time.perf_counter()
                walls.append(t2 - t0)
                if len(walls) >= 3 and t2 >= t_end:
                    break
            if arm == "on":
                led_s.snapshot()
            means[arm].append(sum(walls) / len(walls))
    led_s.flush()
    w_off = statistics.fmean(means["off"])

    def delta_pct(arm):
        return 100 * statistics.fmean(
            y - x for x, y in zip(means["off"], means[arm])) / w_off

    # The floor of any call there: a method that does nothing, called
    # with a note's arguments right after each step's sync.
    class _Null:
        def note_step(self, step=None, count=1, device=None, host=None):
            return None

    null, nulls = _Null(), []
    for _ in range(len(notes)):
        mean = aa_step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        null.note_step(device={"loss": mean})
        nulls.append(time.perf_counter() - t1)
    note_mean = sum(notes) / len(notes)
    out["after_step"] = {
        "null_call_median_us": statistics.median(nulls) * 1e6,
        "null_call_mean_us": statistics.fmean(nulls) * 1e6,
        "note_min_us": min(notes) * 1e6,
        "note_median_us": statistics.median(notes) * 1e6,
        "note_mean_us": note_mean * 1e6,
        "note_p90_us": sorted(notes)[int(0.9 * len(notes))] * 1e6,
        "notes": len(notes),
        "gc_in_notes_us": gc_s[0] * 1e6, "gc_in_notes": gc_s[1],
        "step_off_mean_ms": w_off * 1e3,
        "step_on_mean_ms": statistics.fmean(means["on"]) * 1e3,
        "note_mean_pct_of_step": 100 * note_mean / w_off,
        "aa_wall_delta_pct": delta_pct("on"),
        "off_off_delta_pct": delta_pct("off2"),
    }
    # The skew stamp as a trainer pays it: --stamp-batches batches of
    # --stamp-per-batch GoodputLedger skew stamps, each batch right after
    # a synchronised step; the mean of all and the batch means' spread.
    led_g = _goodput.GoodputLedger(
        telemetry=Telemetry(run_id="skew_costs"), rank="sc")
    per, batch_us = args.stamp_per_batch, []
    for bi in range(args.stamp_batches):
        aa_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(per):
            led_g.skew.record(bi * per + i, 1, 0.0, 1.0)
        batch_us.append((time.perf_counter() - t0) / per * 1e6)
    stamp_mean = statistics.fmean(batch_us)
    out["skew_stamp_after_step"] = {
        "mean_us": stamp_mean, "min_batch_us": min(batch_us),
        "max_batch_us": max(batch_us), "batches": len(batch_us),
        "per_batch": per,
        "mean_pct_of_step": 100 * stamp_mean * 1e-6 / w_off,
    }
    if prof is not None:
        import pstats

        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
        out["profile_us_per_note"] = [
            [f"{os.path.basename(fn)}:{line}({name})",
             round(tt / len(notes) * 1e6, 3), round(ct / len(notes) * 1e6, 3)]
            for (fn, line, name), (_cc, _nc, tt, ct, _callers) in top]
    print(json.dumps({"card": card, "root": root,
                      "torch": torch.__version__, "calls": n, "batches": b,
                      "pieces": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
