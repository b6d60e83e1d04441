"""bench_torch.py's attribution knobs against bench.py's, on the CPU at 24x32
for 2 frames (tests/torch_bench_cases.py: metric, frames exact, checksum
relative 1e-4): BENCH_MOVING_MODE=still (a frozen camera that says it
moved every frame) and BENCH_AN_ENV=0 (an_full under the gradient sky).
Also: mode `still` hands the frame the host flag True, so TAA takes its
reprojection path as the device flag says, and an unknown mode fails.
"""

import pytest
import torch

from tests.torch_bench_cases import FRAMES, H, W, benches, check_case

torch.set_num_threads(2)


def test_moving_still_matches_bench_py(monkeypatch):
    want, got = check_case(monkeypatch, "moving", BENCH_MOVING_MODE="still")
    assert got["metric"].endswith(", mode=still")


def test_an_full_without_env_matches_bench_py(monkeypatch):
    want, got = check_case(monkeypatch, "an_full", BENCH_AN_ENV="0")
    assert got["metric"].startswith("analytic scene (baseline), 32x24")


@pytest.mark.parametrize("mode", ["full", "yaw", "dolly", "still"])
def test_moving_modes_mark_every_frame_moved(monkeypatch, mode):
    """Every mode's frames carry camera_moved = 1 on the device and True on
    the host, the frozen camera of `still` too; `still` keeps one pose."""
    _, bench_torch = benches(monkeypatch)
    monkeypatch.setenv("BENCH_MOVING_MODE", mode)
    seen = {}

    def fake_run_frames(params, bvh, fins, height, width, device, **kw):
        seen["fins"] = fins
        return 1.0, 1.0, {}
    monkeypatch.setattr(bench_torch, "_run_frames", fake_run_frames)
    bench_torch.measure_moving(H, W, FRAMES + 1)
    fins = seen["fins"]
    assert len(fins) == FRAMES + 1
    assert all(f.moved is True and int(f.camera_moved) == 1 for f in fins)
    poses = {tuple(f.cam_pos.tolist() + f.cam_fwd.tolist()) for f in fins}
    assert (len(poses) == 1) == (mode == "still")
    # the first frame's previous view-projection is the starting pose's
    assert torch.equal(fins[1].prev_view_proj, fins[0].curr_view_proj)


def test_unknown_moving_mode_fails(monkeypatch):
    _, bench_torch = benches(monkeypatch)
    monkeypatch.setenv("BENCH_MOVING_MODE", "sideways")
    with pytest.raises(SystemExit, match="unknown BENCH_MOVING_MODE"):
        bench_torch.measure_moving(H, W, FRAMES)
