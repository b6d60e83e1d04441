"""Per-frame temporal state on the host.

A copy of `opengl_raytracing_tpu/frame_state.py` without its pytree
registration: the port's frames take the matrices as words of their
device block through `convert.frame_inputs_from_numpy`.  Replaces the
reference's mutable `rt::FrameState`
(reference: include/render/frame_state.h:15-86): current/previous
view-projection matrices, camera positions, and the per-frame jitter.
`begin_frame` / `end_frame` return new values instead of mutating.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FrameState:
    curr_view_proj: np.ndarray   # [4,4] f32
    prev_view_proj: np.ndarray   # [4,4] f32
    curr_cam_pos: np.ndarray     # [3] f32
    prev_cam_pos: np.ndarray     # [3] f32
    jitter: np.ndarray           # [2] f32, pixels

    @staticmethod
    def initial(view_proj: np.ndarray, cam_pos: np.ndarray) -> "FrameState":
        """Seed prev matrices with the initial camera so frame 0 has zero
        motion (reference: src/app/application.cpp:316-319)."""
        vp = np.asarray(view_proj, np.float32)
        cp = np.asarray(cam_pos, np.float32)
        return FrameState(vp, vp, cp, cp, np.zeros(2, np.float32))

    def begin_frame(self, view_proj, cam_pos, jitter) -> "FrameState":
        return FrameState(
            curr_view_proj=np.asarray(view_proj, np.float32),
            prev_view_proj=self.prev_view_proj,
            curr_cam_pos=np.asarray(cam_pos, np.float32),
            prev_cam_pos=self.prev_cam_pos,
            jitter=np.asarray(jitter, np.float32),
        )

    def end_frame(self) -> "FrameState":
        # prev <- curr (reference: include/render/frame_state.h:81-84)
        return FrameState(self.curr_view_proj, self.curr_view_proj,
                          self.curr_cam_pos, self.curr_cam_pos, self.jitter)

    def camera_moved(self, tol: float = 1e-5) -> bool:
        """max |currVP - prevVP| > tol
        (reference: src/app/application.cpp:387-395)."""
        return bool(np.max(np.abs(np.asarray(self.curr_view_proj)
                                  - np.asarray(self.prev_view_proj))) > tol)
