"""Executor-process entry for the localspark runtime — the port of ``sparktorch_tpu/spark/_executor.py``.

Spawned by ``localsession.RDD._run_executors`` as ``python -m
sparktorch_tpu_torch.spark._executor <payload> <result>``: one process
per partition, the analog of Spark's forked Python workers. The shim is
installed before the payload is unpickled, since dill imports the
closure's modules and those import ``pyspark``.
"""

import sys


def main(payload_path: str, result_path: str) -> None:
    from sparktorch_tpu_torch.spark import localsession

    localsession.install()

    import json

    import dill

    with open(payload_path, "rb") as f:
        header = json.loads(f.readline())
        for p in header["sys_path"]:
            if p not in sys.path:
                sys.path.append(p)
        payload = dill.load(f)

    if payload["barrier"]:
        localsession.BarrierTaskContext._current = localsession.BarrierTaskContext(
            payload["partition_id"], payload["world"]
        )

    out = payload["fn"](iter(payload["rows"]))
    with open(result_path, "wb") as f:
        dill.dump(list(out), f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
