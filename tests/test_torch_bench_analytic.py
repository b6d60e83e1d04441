"""bench_torch.py's analytic cases (an_baseline at its fixed 800x600,
an_full under the day-sky cubemap) and the moving camera against
bench.py's, on the CPU (24x32 but for an_baseline) for 2 frames.  The
comparison and its tolerance are in tests/torch_bench_cases.py.

An 800x600 analytic frame takes seconds on the CPU, so an_baseline's
port side times one chain after its warm one, not five: the five chains
and their one checksum are held on every other case.
"""

import pytest
import torch

from tests.torch_bench_cases import check_case

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["an_baseline", "an_full", "moving"])
def test_analytic_and_moving_cases_match_bench_py(monkeypatch, case):
    if case == "an_baseline":
        import bench_torch
        monkeypatch.setattr(bench_torch, "TIMED_CHAINS", 1)
    want, got = check_case(monkeypatch, case)
    if case == "an_baseline":
        assert got["metric"].endswith("800x600 1spp")
    if case == "an_full":
        assert "full+env" in got["metric"]
