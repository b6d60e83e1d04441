"""bench_torch.py's BVH-heavy cases (cf_far, cf_close: make_bunny(6), 81,920
triangles, the baseline preset, bench.py's far and close cameras) against
bench.py's, on the CPU at 24x32 for 2 frames.  Each bench builds its own
tree.  The comparison and its tolerance are in tests/torch_bench_cases.py;
`ordered_primary` is 0 in both (JAX's auto with ORDERED_AUTO_FACTOR 0.0).
"""

import pytest
import torch

from tests.torch_bench_cases import check_case

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["cf_far", "cf_close"])
def test_closefar_case_matches_bench_py(monkeypatch, case):
    want, got = check_case(monkeypatch, case)
    assert got["ordered_primary"] == want["ordered_primary"] == 0
