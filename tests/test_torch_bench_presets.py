"""bench_torch.py's preset cases (baseline, realistic, full, heavy: the
bunny BVH scene, still camera) against bench.py's, on the CPU at 24x32
for 2 frames.  The comparison and its tolerance are in
tests/torch_bench_cases.py: metric, frames exact, checksum relative 1e-4.
"""

import pytest
import torch

from tests.torch_bench_cases import PRESET_CASES, check_case

torch.set_num_threads(2)


@pytest.mark.parametrize("case", PRESET_CASES)
def test_preset_case_matches_bench_py(monkeypatch, case):
    want, got = check_case(monkeypatch, case)
    assert got["unit"] == want["unit"] == "Mrays/s"
    # at 24x32 the rates round to 0.0; the headline's keys are there
    for key in ("value", "vs_baseline", "total_mrays_per_s"):
        assert got[key] >= 0.0
