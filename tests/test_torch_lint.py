"""The port's sparklint (``sparktorch_tpu_torch.lint``) against the JAX
package's (``sparktorch_tpu.lint``).

- Every rule shared with the JAX package gives the same ``(rule, line,
  col)`` findings on every fixture of ``tests/fixtures/lint/``, and the
  same again when a fixture sits under a ``sparktorch_tpu/<rel>`` and a
  ``sparktorch_tpu_torch/<rel>`` path (the engines scope their own
  package's files alike).
- The rules re-aimed at torch (SPK108 readbacks, SPK401
  ``torch.compile`` recompiles, SPK402 ``torch.distributed`` groups)
  hold their true-positive and true-negative fixtures in
  ``tests/fixtures/lint_torch/``.
- The registry, selectors, suppression, the CLI's exit codes, JSON
  schema, ``--gate-wall`` and ``--log``, and the whole port linting
  clean.
- The repairs the lint found: the native build no longer holds its lock
  across the compiler, and the gang coordinator's values read after
  ``stop()`` (annotated SPK501 in the bench) are the values it had.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest

import sparktorch_tpu.lint as jax_lint
import sparktorch_tpu_torch
from sparktorch_tpu.lint.core import lint_file as jax_lint_file
from sparktorch_tpu_torch.lint import ALL_RULES, rules_by_selector
from sparktorch_tpu_torch.lint import cli
from sparktorch_tpu_torch.lint.core import (
    PARSE_RULE_ID,
    lint_file,
    package_rel,
    run_lint,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SHARED = os.path.join(HERE, "fixtures", "lint")
TORCH = os.path.join(HERE, "fixtures", "lint_torch")
PKG_DIR = os.path.dirname(os.path.abspath(sparktorch_tpu_torch.__file__))

#: Rules the port carries over unchanged (IDs, slugs, scoping).
CARRIED = ("SPK101", "SPK102", "SPK103", "SPK104", "SPK105", "SPK106",
           "SPK107", "SPK201", "SPK301", "SPK501")

PORT_CARRIED = tuple(r for r in ALL_RULES if r.id in CARRIED)
JAX_CARRIED = tuple(r for r in jax_lint.ALL_RULES if r.id in CARRIED)

SHARED_FIXTURES = sorted(f for f in os.listdir(SHARED) if f.endswith(".py"))

# Package-relative homes a fixture is placed at for the scoping check:
# each one sits inside or outside some rule's scope.
RELS = ("obs/telemetry.py", "obs/skew.py", "obs/profile.py",
        "obs/timeline.py", "obs/replay.py", "train/step.py",
        "serve/infer.py", "ctl/elastic.py", "net/bench_wire.py",
        "bench.py", "lint/cli.py", "utils/data.py")

TORCH_TRUE_POSITIVES = {
    "async_fetch_tp.py": {"SPK108": 8},
    "recompile_tp.py": {"SPK401": 4},
    "collective_tp.py": {"SPK402": 6},
}
TORCH_TRUE_NEGATIVES = ["async_fetch_tn.py", "recompile_tn.py",
                        "collective_tn.py"]


def _where(findings):
    return sorted((f.rule, f.line, f.col) for f in findings)


def _counts(findings):
    out = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


def test_registry_matches_the_jax_registry():
    ids = [r.id for r in ALL_RULES]
    assert ids == sorted(ids) == [r.id for r in jax_lint.ALL_RULES]
    assert len({r.slug for r in ALL_RULES}) == len(ids)
    jax_slugs = {r.id: r.slug for r in jax_lint.ALL_RULES}
    for r in ALL_RULES:
        assert r.summary and r.why, f"{r.id} must document its bug class"
        want = "recompile-hazard" if r.id == "SPK401" else jax_slugs[r.id]
        assert r.slug == want


@pytest.mark.parametrize("name", SHARED_FIXTURES)
def test_shared_fixture_findings_equal_the_jax_engines(name):
    path = os.path.join(SHARED, name)
    port = lint_file(path, PORT_CARRIED)
    assert _where(port) == _where(jax_lint_file(path, JAX_CARRIED))
    if name.endswith("_tp.py"):
        assert port or name in ("async_fetch_tp.py", "retrace_tp.py",
                                "collective_tp.py"), name


@pytest.mark.parametrize("rel", RELS)
def test_scoping_equals_the_jax_engines(rel, tmp_path):
    """A fixture under ``sparktorch_tpu/<rel>`` (the JAX engine) and
    under ``sparktorch_tpu_torch/<rel>`` (the port's) gives equal
    findings; SPK108 keeps the JAX rule's scope."""
    jax_file = tmp_path / "sparktorch_tpu" / rel
    port_file = tmp_path / "sparktorch_tpu_torch" / rel
    jax_file.parent.mkdir(parents=True)
    port_file.parent.mkdir(parents=True)
    assert package_rel(str(port_file)) == rel
    for name in SHARED_FIXTURES:
        shutil.copy(os.path.join(SHARED, name), jax_file)
        shutil.copy(os.path.join(SHARED, name), port_file)
        assert _where(lint_file(str(port_file), PORT_CARRIED)) == _where(
            jax_lint_file(str(jax_file), JAX_CARRIED)), (rel, name)
    port_108 = next(r for r in ALL_RULES if r.id == "SPK108")
    jax_108 = next(r for r in jax_lint.ALL_RULES if r.id == "SPK108")
    assert port_108.applies(rel) == jax_108.applies(rel)


@pytest.mark.parametrize("name", sorted(TORCH_TRUE_POSITIVES))
def test_torch_true_positive_fixture(name):
    findings = lint_file(os.path.join(TORCH, name), ALL_RULES)
    assert _counts(findings) == TORCH_TRUE_POSITIVES[name]


@pytest.mark.parametrize("name", TORCH_TRUE_NEGATIVES)
def test_torch_true_negative_fixture(name):
    assert lint_file(os.path.join(TORCH, name), ALL_RULES) == []


def test_async_fetch_scoped_to_trainers_and_skew(tmp_path):
    """SPK108 reads only train/ and obs/skew.py: the same readbacks in a
    serving module or in another obs module are not its business."""
    src = os.path.join(TORCH, "async_fetch_tp.py")
    found = {}
    for rel in ("train/hogwild.py", "obs/skew.py", "obs/health.py",
                "serve/infer.py"):
        dst = tmp_path / "sparktorch_tpu_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
        found[rel] = _counts(lint_file(str(dst), ALL_RULES)).get("SPK108", 0)
    assert found == {"train/hogwild.py": 8, "obs/skew.py": 8,
                     "obs/health.py": 0, "serve/infer.py": 0}


def test_collective_rule_names_the_op_and_skips_parameter_groups(tmp_path):
    p = tmp_path / "c.py"
    p.write_text("import torch\n"
                 "def f(t, group):\n"
                 "    torch.distributed.all_reduce(t, group=group)\n"
                 "    torch.distributed.reduce_scatter_tensor(t, t)\n")
    findings = lint_file(str(p), ALL_RULES)
    assert [(f.rule, f.line) for f in findings] == [("SPK402", 4)]
    assert "`reduce_scatter_tensor`" in findings[0].message


def test_suppression_same_line_and_preceding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nts = time.time()\n")
    assert _counts(lint_file(str(bad), ALL_RULES)) == {"SPK201": 1}
    annotated = tmp_path / "annotated.py"
    annotated.write_text(
        "import time\n"
        "ts = time.time()  # lint-obs: ok (test)\n"
        "# lint-obs: ok (test, preceding line)\n"
        "t2 = time.time()\n")
    assert lint_file(str(annotated), ALL_RULES) == []


def test_parse_and_read_errors_are_findings(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    assert [f.rule for f in lint_file(str(p), ALL_RULES)] == [PARSE_RULE_ID]
    missing = lint_file(str(tmp_path / "missing.py"), ALL_RULES)
    assert [f.rule for f in missing] == [PARSE_RULE_ID]
    assert "could not read" in missing[0].message


def test_rule_selectors():
    assert [r.id for r in rules_by_selector(["SPK301"])] == ["SPK301"]
    assert [r.id for r in rules_by_selector(["recompile-hazard"])] == [
        "SPK401"]
    assert [r.id for r in rules_by_selector(["spk402", "TIMING-LEDGER"])
            ] == ["SPK402", "SPK201"]
    assert rules_by_selector([]) == ALL_RULES
    with pytest.raises(KeyError):
        rules_by_selector(["retrace-hazard"])


def test_package_rel_scoping():
    assert package_rel(os.path.join(PKG_DIR, "obs", "telemetry.py")) \
        == "obs/telemetry.py"
    assert package_rel(os.path.join(SHARED, "timing_tp.py")) is None
    assert package_rel("/x/sparktorch_tpu/obs/telemetry.py") is None


def test_full_tree_clean_and_under_wall_gate():
    """Zero unexplained findings over the whole port; the wall bound is
    a generous backstop against a pathological regression only."""
    t0 = time.perf_counter()
    findings, n_files = run_lint([PKG_DIR], ALL_RULES)
    wall = time.perf_counter() - t0
    assert findings == [], "\n".join(f.render() for f in findings)
    assert n_files > 80
    assert wall < 30.0, f"analyzer wall {wall:.2f}s is pathological"


# ---------------------------------------------------------------- CLI


def _main(capsys, *args):
    rc = cli.main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_module_entry_point_exit_codes_and_json():
    """``python -m sparktorch_tpu_torch.lint``: 0 and "clean" on a clean
    file, 1 with the versioned JSON schema on findings."""
    cmd = [sys.executable, "-m", "sparktorch_tpu_torch.lint"]
    ok = subprocess.run(cmd + [os.path.join(SHARED, "obs_misc_tn.py")],
                        capture_output=True, text=True, cwd=HERE + "/..")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "clean" in ok.stdout
    bad = subprocess.run(cmd + [os.path.join(SHARED, "obs_misc_tp.py"),
                                "--json"],
                         capture_output=True, text=True, cwd=HERE + "/..")
    assert bad.returncode == 1
    doc = json.loads(bad.stdout)
    assert set(doc) == {"version", "files_scanned", "wall_s", "rules",
                        "counts", "findings"}
    assert doc["version"] == 1 and doc["files_scanned"] == 1
    assert doc["counts"] == {"SPK101": 1, "SPK102": 1, "SPK103": 1,
                             "SPK104": 1, "SPK105": 1}
    for f in doc["findings"]:
        assert set(f) == {"rule", "slug", "path", "line", "col",
                          "message", "snippet"}


def test_cli_json_equals_the_jax_clis_but_for_wall_and_messages(capsys):
    path = os.path.join(SHARED, "timing_tp.py")
    rc, out, _ = _main(capsys, path, "--json", "--rule", "SPK201")
    from sparktorch_tpu.lint import cli as jax_cli

    jrc = jax_cli.main([path, "--json", "--rule", "SPK201"])
    jdoc = json.loads(capsys.readouterr().out)
    doc = json.loads(out)
    assert rc == jrc == 1
    for d in (doc, jdoc):
        d.pop("wall_s")
        for f in d["findings"]:
            f.pop("message")
    assert doc == jdoc


def test_cli_unknown_rule_and_missing_or_empty_path(capsys, tmp_path):
    rc, _, err = _main(capsys, os.path.join(SHARED, "obs_misc_tp.py"),
                       "--rule", "nonsense")
    assert rc == 2 and "unknown rule: nonsense" in err
    rc, _, err = _main(capsys, str(tmp_path / "no_such_dir"))
    assert rc == 2 and "no such path" in err
    empty = tmp_path / "empty"
    empty.mkdir()
    rc, _, err = _main(capsys, str(empty))
    assert rc == 2 and "no .py files" in err


def test_cli_rule_filter_and_list(capsys):
    rc, out, _ = _main(capsys, os.path.join(SHARED, "obs_misc_tp.py"),
                       "--rule", "obs-print", "--json")
    assert rc == 1 and json.loads(out)["counts"] == {"SPK101": 1}
    rc, out, _ = _main(capsys, "--list-rules")
    assert rc == 0
    for rule in ALL_RULES:
        assert rule.id in out and rule.slug in out


def test_cli_gate_wall_breach_and_log(capsys, tmp_path):
    log = tmp_path / "lint.jsonl"
    rc, _, err = _main(capsys, os.path.join(SHARED, "obs_misc_tn.py"),
                       "--gate-wall", "0.0000001", "--log", str(log))
    assert rc == 1 and "exceeds --gate-wall" in err
    rc, _, _ = _main(capsys, os.path.join(SHARED, "obs_misc_tn.py"),
                     "--gate-wall", "60", "--log", str(log))
    assert rc == 0
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["ok"] for r in recs] == [False, True]
    assert recs[0]["config"] == "lint" and recs[0]["findings"] == 0
    assert recs[0]["gate_wall_s"] == pytest.approx(1e-7)


# -------------------------------------------------- repairs it found


def test_native_load_never_waits_for_another_librarys_build(
        monkeypatch, tmp_path):
    """SPK301 at ``native/build.py``: the compiler ran under the
    module's lock, so loading a library that was already built waited
    for any other library's build. The build now runs outside it."""
    from sparktorch_tpu_torch.native import build

    slow_cxx = tmp_path / "slow_cxx.sh"
    slow_cxx.write_text("#!/bin/sh\nsleep 2\nexit 1\n")
    slow_cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(slow_cxx))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    ready = object()
    monkeypatch.setattr(build, "_CACHE", {"ready": ready})
    errors = []

    def building():
        try:
            build.load_library("gang")
        except RuntimeError as exc:
            errors.append(exc)

    t = threading.Thread(target=building)
    t.start()
    time.sleep(0.3)
    t0 = time.perf_counter()
    assert build.load_library("ready") is ready
    waited = time.perf_counter() - t0
    t.join()
    assert waited < 1.0, f"a built library's load waited {waited:.2f}s"
    assert len(errors) == 1 and "exit 1" in str(errors[0])
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_stopped_coordinator_keeps_the_values_the_bench_reads():
    """SPK501 at the bench's elastic config: ``coord.generation`` and
    ``coord.world_size`` are read after ``coord.stop()``. The port's
    coordinator freezes its native state on ``stop()``, so the reads
    are the values it had (the annotation's claim)."""
    from sparktorch_tpu_torch.native.gang import GangCoordinator

    coord = GangCoordinator(world_size=3, port=0)
    gen = coord.resize(2)
    before = (coord.generation, coord.world_size, coord.failed)
    coord.stop()
    assert (coord.generation, coord.world_size, coord.failed) == before
    assert before[:2] == (gen, 2) and gen >= 1
