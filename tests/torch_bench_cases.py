"""One bench case through bench.py (the JAX package on the CPU) and through
bench_torch.py (the port, BENCH_FORCE_CPU=1), for tests/test_torch_bench_*.py.

Both benches' `measure_*` functions run at 24x32 (an_baseline at its fixed
800x600) for 2 frames.  Each builds its own scene, tree and inputs: no
JAX state is handed across.  Held equal: the `metric` string, `frames`
and `ordered_primary` exactly, the checksum (the sum of every frame's
image) within relative 1e-4 (tests/test_torch_pipeline.py's tolerance on
the frames; bench.py rounds its checksum to 0.1, ~5e-5 of these sums).
The port's line must also carry five timed chains with one checksum, the
CPU as its device and a profile that says it was not measured.
"""

import importlib

import numpy as np

H, W, FRAMES = 24, 32, 2
RTOL = 1e-4
PRESET_CASES = ("baseline", "realistic", "full", "heavy")


def benches(monkeypatch):
    """(bench, bench_torch); bench.py is first imported with its compile
    cache off (BENCH_NO_CACHE=1), so its import sets no JAX cache dir."""
    monkeypatch.setenv("BENCH_NO_CACHE", "1")
    monkeypatch.setenv("BENCH_FORCE_CPU", "1")
    return (importlib.import_module("bench"),
            importlib.import_module("bench_torch"))


def measure(mod, case):
    """`case` through module `mod`'s measure_* function at the test size."""
    if case in PRESET_CASES:
        return mod.measure_preset(H, W, FRAMES, case)
    if case in ("an_baseline", "an_full"):
        return mod.measure_analytic(H, W, FRAMES, case)
    if case == "moving":
        return mod.measure_moving(H, W, FRAMES)
    return mod.measure_closefar(H, W, FRAMES, case.replace("cf_", ""))


def check_case(monkeypatch, case, **env):
    """Both benches' records of `case` under the env knobs `env`, held to
    each other; returns (JAX's record, the port's)."""
    bench, bench_torch = benches(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = measure(bench, case)
    got = bench_torch._finish(measure(bench_torch, case))
    assert got["metric"] == want["metric"]
    assert got["frames"] == want["frames"] == FRAMES
    assert got.get("ordered_primary") == want.get("ordered_primary")
    assert set(want) <= set(got), sorted(set(want) - set(got))
    np.testing.assert_allclose(got["checksum"], want["checksum"], rtol=RTOL,
                               err_msg=case)
    assert np.isfinite(got["checksum"]) and got["checksum"] > 0
    assert len(got["ms_per_frame_runs"]) == bench_torch.TIMED_CHAINS
    assert got["spread"] >= 1.0
    assert got["device"]["platform"] == "cpu"
    assert got["device_ms"] is None and got["idle"] is None
    assert got["profile_note"].startswith("not measured")
    assert got["peak_mem_mb"] is None
    # the wrappers ran their plain versions: no kernel was launched
    assert not any(got["kernel_launches"].values())
    return want, got
