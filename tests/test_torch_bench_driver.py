"""bench_torch.py's main runner on the CPU: `main` in child processes with
BENCH_FORCE_CPU=1 at 24x32 for 2 frames, and its helpers in process.

- A run prints each case line as its child prints it, the cumulative
  record after every group, and last the cumulative record with
  bench.py's keys; rc 0 when every case passed.
- An unknown case fails its child; its error carries the child's stderr
  line and the run exits non-zero.
- Without a card and without BENCH_FORCE_CPU the run prints an error line
  and exits non-zero (the card is hidden with CUDA_VISIBLE_DEVICES, so
  this holds on a machine with one too).
- A child that outlives its timeout is killed, and a group that timed out
  counts one timeout, however many cases it held.
- The groups are bench.py's; the bench imports nothing of JAX, of the JAX
  package, of bench.py or of scripts/.
No test decides at import time whether a card exists.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "bench_torch.py")
CPU_ENV = dict(BENCH_FORCE_CPU="1", BENCH_HEIGHT="24", BENCH_WIDTH="32",
               BENCH_FRAMES="2", OMP_NUM_THREADS="2")
# one case of each family but the analytic scene's (an 800x600 frame takes
# seconds on the CPU): the presets' group of two, the BVH-heavy scene's,
# and moving alone
CASES = ["baseline", "realistic", "cf_far", "moving"]


def run_bench(timeout=300, **env):
    full = dict(os.environ, **env)
    proc = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                          text=True, env=full, cwd=ROOT, timeout=timeout)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    return proc, lines


@pytest.fixture(scope="module")
def bench_torch():
    sys.path.insert(0, ROOT)
    import bench_torch
    return bench_torch


def test_run_prints_case_lines_then_cumulative():
    proc, lines = run_bench(BENCH_CASES=",".join(CASES), **CPU_ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    case_lines = [ln for ln in lines if "case" in ln]
    assert [ln["case"] for ln in case_lines] == CASES
    for ln in case_lines:
        assert "error" not in ln, ln
        assert ln["device"]["platform"] == "cpu"
        assert ln["frames"] == 2 and len(ln["ms_per_frame_runs"]) == 5
    # the cumulative record after each of the three groups, and once more
    cumulative = [ln for ln in lines if "case" not in ln]
    assert len(cumulative) == 4 and lines[-1] == cumulative[-1]
    last = lines[-1]
    for key in ("metric", "value", "unit", "vs_baseline", "presets",
                "close_far", "ms_per_frame", "fps", "total_mrays_per_s",
                "frames", "checksum"):
        assert key in last, key
    assert "error" not in last
    assert last["metric"].endswith("32x24 1spp, preset=baseline")
    assert set(last["presets"]) == {"baseline", "realistic", "moving"}
    assert set(last["close_far"]) == {"far"}
    assert last["close_far"]["far"]["ordered_primary"] == 0
    assert last["checksum"] == case_lines[0]["checksum"]


def test_unknown_case_fails_with_child_stderr():
    proc, lines = run_bench(BENCH_CASES="nope", **CPU_ENV)
    assert proc.returncode != 0
    (line,) = [ln for ln in lines if ln.get("case") == "nope"]
    assert "unknown bench case 'nope'" in line["error"]
    assert "exited with code 1" in line["error"]
    assert lines[-1]["error"] == "headline case not in BENCH_CASES"
    assert lines[-1]["presets"]["nope"]["error"] == line["error"]


def test_no_card_without_force_cpu_fails():
    env = {k: v for k, v in CPU_ENV.items() if k != "BENCH_FORCE_CPU"}
    full = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_CASES="baseline",
                **env)
    full.pop("BENCH_FORCE_CPU", None)
    proc = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                          text=True, env=full, cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    (line,) = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert "no CUDA card" in line["error"] and "case" not in line


def test_child_past_its_timeout_is_killed(bench_torch, monkeypatch):
    for k, v in CPU_ENV.items():
        monkeypatch.setenv(k, v)
    seen = []
    recs, timed_out = bench_torch._run_group(
        ["baseline", "full"], 0.5, lambda case, rec: seen.append(case))
    assert timed_out and not seen
    for case in ("baseline", "full"):
        assert recs[case]["error"].startswith("timeout after"), recs[case]


@pytest.mark.parametrize("before,timed_out,errors,after", [
    (0, True, (True, True, True, True), 1),   # a group of four: one
    (1, True, (True,), 2),
    (1, False, (False, True), 0),             # a case measured: again 0
    (1, False, (True,), 1),                   # failed, not timed out
])
def test_a_group_timeout_counts_once(bench_torch, before, timed_out, errors,
                                     after):
    recs = {f"c{i}": ({"error": "timeout after 9s"} if err else {})
            for i, err in enumerate(errors)}
    assert bench_torch._timeouts_after(before, timed_out, recs) == after


def test_groups_are_bench_py_groups(bench_torch, monkeypatch):
    monkeypatch.setenv("BENCH_NO_CACHE", "1")
    import bench
    for cases in (bench_torch.CASES, ["moving", "baseline", "cf_far",
                                      "an_full", "full", "x"]):
        assert bench_torch._groups_of(cases) == bench._groups_of(cases)
    assert bench_torch._groups_of(bench_torch.CASES) == [
        ["baseline", "realistic", "full", "heavy"], ["an_baseline", "an_full"],
        ["cf_far", "cf_close"], ["moving"]]


def test_child_times_every_case_before_any_profile(bench_torch, monkeypatch,
                                                   capsys):
    """A child profiles no case before it has timed them all; a case that
    raises gets its error line and the group goes on."""
    calls = []

    def measure_one(case):
        calls.append(("time", case))
        if case == "bad":
            raise RuntimeError("boom")
        return {"checksum": 1.0,
                "_profile": lambda: calls.append(("profile", case)) or {}}
    monkeypatch.setattr(bench_torch, "_measure_one", measure_one)
    bench_torch.child("a,bad,b")
    assert calls == [("time", "a"), ("time", "bad"), ("time", "b"),
                     ("profile", "a"), ("profile", "b")]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["case"] for ln in lines] == ["a", "bad", "b"]
    assert lines[1]["error"] == "RuntimeError: boom"
    assert "_profile" not in lines[0]


def test_informative_line(bench_torch):
    assert bench_torch._informative_line(
        ["Traceback\n", "RuntimeError: boom\n", "  \n", "exit\n"]
    ) == "RuntimeError: boom"
    assert bench_torch._informative_line(["a\n", "b\n"]) == "b"
    assert bench_torch._informative_line([]) == ""


def test_imports_nothing_of_jax():
    """bench_torch.py names no JAX module, no module of the JAX package,
    bench.py or scripts/; a case run in a fresh process loads none."""
    tree = ast.parse(open(SCRIPT).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "opengl_raytracing_tpu", "bench",
                           "scripts"), name
    code = ("import sys, bench_torch; bench_torch.measure_preset(24, 32, 2, "
            "'baseline'); print(sorted(m for m in sys.modules if m.split('.')"
            "[0] in ('jax', 'jaxlib', 'opengl_raytracing_tpu', 'bench', "
            "'scripts')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300,
                          env=dict(os.environ, **CPU_ENV))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
