"""bench.py capture-harness machinery (no device, no jax backend touched).

The headline metric is captured by running bench.py once, so the watchdog
that turns a hung or failed measuring child into one JSON line anyway gets
regression tests, as do the progress-file summary and the child's refusal
of any device but a GPU.
"""

import importlib.util
import os
import sys

import pytest

_BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")


@pytest.fixture()
def bench_mod():
    # load bench.py as a module WITHOUT running main(); the module only
    # imports jax.numpy at top level (conftest already forces CPU)
    spec = importlib.util.spec_from_file_location("bench_under_test", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}

_FAKE_CHILD_OK = """
import json, os
with open(os.environ["BENCH_PROGRESS_FILE"], "a") as f:
    f.write(json.dumps({"device": %r}) + "\\n")
    f.write(json.dumps({"pushes": 1.1e9, "elapsed": 1.0, "window": 0}) + "\\n")
    f.write(json.dumps({"pushes": 2.6e9, "elapsed": 2.0, "window": 1}) + "\\n")
""" % (_DEVICE,)

_FAKE_CHILD_HANG = """
import json, os, time
with open(os.environ["BENCH_PROGRESS_FILE"], "a") as f:
    f.write(json.dumps({"pushes": 9.9e8, "elapsed": 1.0, "window": 0}) + "\\n")
    f.flush()
time.sleep(120)
"""

_FAKE_CHILD_SILENT_HANG = "import time; time.sleep(120)"


def _run_watchdog(bench_mod, tmp_path, child_src, deadline_s):
    import sys as _sys

    progress = tmp_path / "progress.jsonl"
    progress.write_text("")
    return bench_mod._watchdog(
        [_sys.executable, "-c", child_src], deadline_s, str(progress)
    )


def test_watchdog_clean_finish(bench_mod, tmp_path):
    # all pushes over all timed time, with the window rates' spread
    value, notes = _run_watchdog(bench_mod, tmp_path, _FAKE_CHILD_OK, 60)
    assert value == pytest.approx(3.7e9 / 3.0)
    assert notes["windows"] == 2
    assert notes["window_rates"] == {
        "median": pytest.approx(1.2e9), "min": 1.1e9, "max": 1.3e9}
    assert notes["device"] == _DEVICE
    assert "degraded" not in notes and "deadline_hit" not in notes


def test_watchdog_reports_best_so_far_on_hang(bench_mod, monkeypatch, tmp_path):
    # the deadline must convert a hung child into best-so-far, not rc=124
    monkeypatch.setattr(bench_mod, "_KILL_MARGIN_S", 0.0)
    value, notes = _run_watchdog(bench_mod, tmp_path, _FAKE_CHILD_HANG, 3)
    assert value == 9.9e8
    assert notes["windows"] == 1
    assert notes["deadline_hit"] is True


def test_watchdog_degraded_when_nothing_completed(bench_mod, monkeypatch, tmp_path):
    monkeypatch.setattr(bench_mod, "_KILL_MARGIN_S", 0.0)
    value, notes = _run_watchdog(bench_mod, tmp_path, _FAKE_CHILD_SILENT_HANG, 3)
    assert value == 0.0
    assert "degraded" in notes


def test_watchdog_end_to_end_prints_one_json_line(bench_mod, tmp_path):
    # full contract: `python bench.py` with a hung MEASURING child still
    # prints exactly one parseable JSON line on stdout and exits 0
    import json as _json
    import subprocess
    import sys as _sys

    env = dict(os.environ)
    env[bench_mod._DEADLINE_ENV] = "4"
    env.pop(bench_mod._ROLE_ENV, None)
    # make the spawned child hang instead of benchmarking: point the child
    # role at a sleeping interpreter by running the watchdog directly
    progress = tmp_path / "p.jsonl"
    src = (
        "import sys; sys.path.insert(0, %r); import importlib.util;"
        "spec = importlib.util.spec_from_file_location('b', %r);"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m);"
        "m._KILL_MARGIN_S = 0.0;"
        "v, n = m._watchdog([sys.executable, '-c', 'import time; time.sleep(60)'],"
        " 3, %r); m._emit(v, **n)"
    ) % (os.path.dirname(_BENCH), _BENCH, str(progress))
    out = subprocess.run(
        [_sys.executable, "-c", src],
        env=env,
        capture_output=True,
        text=True,
        timeout=60,
    )
    assert out.returncode == 0
    lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
    assert len(lines) == 1
    rec = _json.loads(lines[0])
    assert rec["metric"] == bench_mod.METRIC_NAME
    assert rec["unit"] == "pushes/s"
    assert rec["value"] == 0.0 and "degraded" in rec
    assert "vs_baseline" not in rec  # no baseline until the ledger has one


def test_best_progress_ignores_malformed_tail(bench_mod, tmp_path):
    p = tmp_path / "p.jsonl"
    p.write_text('{"pushes": 5.0, "elapsed": 1.0}\n'
                 '{"pushes": 7.0, "elapsed": 1.0}\n{"pushes": 9')  # torn write
    value, notes = bench_mod._read_progress(str(p))
    assert value == 6.0
    assert notes["windows"] == 2
    assert notes["window_rates"] == {"median": 6.0, "min": 5.0, "max": 7.0}


def test_best_progress_only_counts_settled_bucket(bench_mod, tmp_path):
    # windows timed at a sub-capacity bucket that later
    # overflowed do less dead-lane work per push and read HIGH; only the
    # largest (settled) bucket's windows may win
    import json as _json

    p = tmp_path / "p.jsonl"
    rows = [
        {"pushes": 9.0e8, "elapsed": 1.0, "w": 1 << 20},  # pre-overflow: bogus
        {"pushes": 9.5e8, "elapsed": 1.0, "w": 1 << 20},
        {"pushes": 8.0e8, "elapsed": 1.0, "w": 1 << 21},  # settled bucket
        {"pushes": 8.4e8, "elapsed": 1.0, "w": 1 << 21},
    ]
    p.write_text("".join(_json.dumps(r) + "\n" for r in rows))
    value, notes = bench_mod._read_progress(str(p))
    assert value == pytest.approx(8.2e8)
    assert notes["windows"] == 2
    assert notes["w"] == 1 << 21


def test_watchdog_reports_settled_bucket_in_notes(bench_mod, tmp_path):
    src = """
import json, os
with open(os.environ["BENCH_PROGRESS_FILE"], "a") as f:
    f.write(json.dumps({"pushes": 1.5e9, "elapsed": 1.0, "w": 1048576}) + "\\n")
    f.write(json.dumps({"pushes": 1.2e9, "elapsed": 1.0, "w": 2097152}) + "\\n")
"""
    value, notes = _run_watchdog(bench_mod, tmp_path, src, 60)
    assert value == 1.2e9  # the 1.5e9 smaller-bucket window must not count
    assert notes["w"] == 2097152


def test_child_soft_deadline_helpers(bench_mod, monkeypatch):
    import time as _time

    monkeypatch.setenv(bench_mod._DEADLINE_TS_ENV, repr(_time.monotonic() + 30))
    assert bench_mod._out_of_time(60) is True
    assert bench_mod._out_of_time(10) is False
    monkeypatch.delenv(bench_mod._DEADLINE_TS_ENV)
    assert bench_mod._out_of_time(1e9) is False  # no deadline armed

def test_child_refuses_cpu(tmp_path):
    """The measuring child exits non-zero on the CPU before timing
    anything, so the interpreter is never reported as a device rate."""
    import subprocess

    progress = tmp_path / "p.jsonl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_ROLE="child",
               BENCH_PROGRESS_FILE=str(progress))
    out = subprocess.run([sys.executable, _BENCH], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not progress.exists() or progress.read_text() == ""


def test_bench_on_cpu_prints_degraded_line():
    """`python bench.py` without a GPU: one JSON line, value 0.0, a
    degraded note naming the child's exit code, and no device."""
    import json as _json
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("BENCH_ROLE", None)
    out = subprocess.run([sys.executable, _BENCH], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0
    lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
    assert len(lines) == 1
    rec = _json.loads(lines[0])
    assert rec["value"] == 0.0 and rec["windows"] == 0
    assert "rc=" in rec["degraded"] and "device" not in rec
