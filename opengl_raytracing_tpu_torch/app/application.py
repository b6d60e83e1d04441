"""Application: the frame loop orchestrator.

Counterpart of `opengl_raytracing_tpu/app/application.py`.  Mirrors the
reference main loop (reference: src/app/application.cpp:327-555) step for
step: point-light orbit animation, input consumption, camera-moved
detection from the view-projection diff, motion-scaled jitter, hotkey
reactions, render dispatch (ray vs raster), picker-driven asset reloads,
and the accumulation-reset decision driven by the exhaustive param diff.

With `jit` (the default, as the JAX package's `--jit`) a frame on the
card is a replay of its CUDA graph (models/graph.py), captured once per
static configuration: the turbo chain replays it k times, the first frame
with the camera's key (moved or still) and the others with the still one,
and the uint8 image the viewer streams is quantized inside the graph.
The data fields reach the graph through the parameter block
(models/param_block.py), so the point-light orbit's steps and every
slider move replay it too; the turbo chain steps aside under the orbit,
as the JAX package's does.  The raster preview (F2) is a replay of its
own graph under `jit` (`graph.render_raster`, the JAX package's jitted
`_raster_fn`), keyed on the static fields alone.  Without `jit`, and on
the CPU, frames run eagerly (`render_frame`, `render_raster`).  Either way the accumulation is written in place
and the step rebinds `app.render_state` at once.  The JAX package's
per-frame resolution of `ordered_primary` is left out: it picks between
two TPU walk schedules, and the port has one walk.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np

from ..convert import frame_inputs_from_numpy
from ..frame_state import FrameState
from ..models import graph
from ..models.pipeline import FrameInputs, render_frame
from ..models.raster import render_raster
from ..params import params_changed
from ..sampling import generate_jitter2d
from .input import InputState, apply_action
from .state import AppState


class Application:
    def __init__(self, state: Optional[AppState] = None, height: int = 1080,
                 width: int = 1920, device="cuda", jit: bool = True):
        self.app = state or AppState(height, width, device=device)
        self.jit = jit
        # ray frames run eagerly on the card under `jit`: none, since the
        # orbit's steps replay their graph too (the viewer reports it)
        self.eager_frames = 0
        self.input = InputState(spp_per_frame=self.app.params.spp_per_frame,
                                exposure=float(self.app.params.exposure))
        self.frame_count = 0
        self.last_output = None
        # want_u8: each ray frame also leaves the presented image
        # quantized to uint8 on the device in `last_u8`: the viewer
        # streams that, and the copy to the host is a quarter of the
        # float image's bytes
        self.want_u8 = False
        self.last_u8 = None
        # turbo: accumulation frames chained per step while the view is
        # IDLE (camera still, no orbit animation, ray mode).  Chaining K
        # still frames per step converges the accumulation Kx faster at
        # the same stream rate (the reference's present loop free-runs).
        self.turbo = 1

    # -- input --

    def act(self, *actions: str) -> None:
        for a in actions:
            apply_action(self.input, a, self.app)
            if a.startswith("move_") or a.startswith("look "):
                self.input.camera_changed_this_frame = True

    def _frame_inputs(self, frame: FrameState, camera_moved: bool,
                      frame_index: int) -> FrameInputs:
        """The FrameInputs of frame `frame_index` on the device (one
        host-to-device copy); the host flag `moved` is set with the device
        one, so TAA takes its still path alone when the camera did not
        move."""
        cam = self.app.camera
        right, up, fwd, thf = cam.basis()
        return frame_inputs_from_numpy(SimpleNamespace(
            cam_pos=cam.position, cam_right=right, cam_up=up, cam_fwd=fwd,
            tan_half_fov=thf, aspect=cam.aspect, jitter=frame.jitter,
            curr_view_proj=frame.curr_view_proj,
            prev_view_proj=frame.prev_view_proj,
            camera_moved=int(camera_moved)), self.app.device, frame_index)

    def _chain(self, frame: FrameState, camera_moved: bool, k: int):
        """The FrameInputs of a step's k frames.  Frame 0 has the real
        camera_moved.  Frames 1..k-1 settle at its camera: camera_moved
        0, prev = curr, still-scale jitter of the frame indices that
        follow."""
        app = self.app
        index = app.render_state.frame_index
        fins = [self._frame_inputs(frame, camera_moved, index)]
        scale = float(app.params.jitter_still_scale)
        for i in range(1, k):
            jitter = (generate_jitter2d(app.host_frame_index + i) * scale
                      if app.params.enable_jitter
                      else np.zeros(2, np.float32))
            settled = FrameState(frame.curr_view_proj, frame.curr_view_proj,
                                 frame.curr_cam_pos, frame.curr_cam_pos,
                                 np.asarray(jitter, np.float32))
            fins.append(self._frame_inputs(settled, False, index + i))
        return fins

    def _render(self, fins):
        """The step's frames, chained: (the last FrameOutputs, its uint8
        image on the device when `want_u8`, else None)."""
        app = self.app
        captured = self.jit and app.device.type == "cuda"
        state, u8 = app.render_state, None
        kw = dict(height=app.height, width=app.width, use_bvh=app.use_bvh,
                  show_motion=app.show_motion)
        for fin in fins:
            if captured:
                state, out, u8 = graph.render(
                    app.params, fin, state, app.env_map, app.bvh,
                    want_u8=self.want_u8, **kw)
            else:
                state, out = render_frame(app.params, fin, state,
                                          app.env_map, app.bvh, **kw)
        app.render_state = state
        if self.want_u8 and u8 is None:
            u8 = graph.quantize_u8(out.image)
        return out, u8

    # -- one frame (reference: application.cpp:330-554) --

    def step(self, dt: float = 1.0 / 60.0):
        app = self.app

        # 1. point-light orbit animation, wrapped to [-360, 360] like the
        # reference so long sessions don't lose f32 precision
        # (application.cpp:343-348)
        if app.params.point_light_orbit_enabled:
            yaw = (float(app.params.point_light_yaw)
                   + float(app.params.point_light_orbit_speed) * dt)
            if yaw > 360.0:
                yaw -= 360.0
            elif yaw < -360.0:
                yaw += 360.0
            app.params = app.params.replace(point_light_yaw=yaw)

        # 2. consume hotkey flags (application.cpp:410-440)
        inp = self.input
        if inp.toggled_ray_mode:
            app.ray_mode = not app.ray_mode
            app.reset_accumulation("mode toggle")
        if inp.reset_accum:
            app.reset_accumulation("manual")
        if inp.toggled_bvh:
            app.use_bvh = not app.use_bvh
            app.reset_accumulation("bvh toggle")
        if inp.changed_spp:
            app.params = app.params.replace(
                spp_per_frame=int(np.clip(inp.spp_per_frame, 1, 16)))
            app.reset_accumulation("spp change")
        if inp.changed_exposure:
            app.params = app.params.replace(
                exposure=float(np.clip(inp.exposure, 0.05, 8.0)))
        if inp.toggled_motion_debug:
            app.show_motion = not app.show_motion
            app.reset_accumulation("motion debug")

        # 3. frame state + camera-moved detection (application.cpp:380-395)
        vp = app.camera.view_projection()
        frame = app.frame.begin_frame(vp, app.camera.position,
                                      np.zeros(2, np.float32))
        camera_moved = frame.camera_moved() or inp.camera_changed_this_frame

        # jitter scaled by motion state (application.cpp:397-405), indexed
        # by host_frame_index (+1 per ray frame, 0 on reset)
        if app.params.enable_jitter:
            base = generate_jitter2d(app.host_frame_index)
            scale = (app.params.jitter_moving_scale if camera_moved
                     else app.params.jitter_still_scale)
            jitter = base * float(scale)
        else:
            jitter = np.zeros(2, np.float32)
        frame = FrameState(frame.curr_view_proj, frame.prev_view_proj,
                           frame.curr_cam_pos, frame.prev_cam_pos,
                           jitter.astype(np.float32))
        app.frame = frame

        # 4. render (application.cpp:453-457)
        k = 1
        if app.ray_mode:
            # Turbo: K frames per step.  Idle (camera still): all K
            # accumulate at the fixed view.  Moving: frame 0 applies the
            # new camera with camera_moved=1, frames 1..k-1 settle at it
            # (moved=0, prev=curr, still-scale jitter) — the same frame
            # sequence the reference loop renders between input events.
            # Moving chains cap at 6 so input latency stays ~1-2 steps.
            # Orbit animation disables chaining (its per-frame yaw diff
            # resets accumulation anyway, matching paramsChanged).
            if self.turbo > 1 and not app.params.point_light_orbit_enabled:
                k = min(self.turbo, 6) if camera_moved else self.turbo
            out, self.last_u8 = self._render(
                self._chain(frame, camera_moved, k))
            app.host_frame_index += k
            self.last_output = out
            image = out.image
        else:
            fin = self._frame_inputs(frame, camera_moved,
                                     app.render_state.frame_index)
            raster = (graph.render_raster
                      if self.jit and app.device.type == "cuda"
                      else render_raster)
            image = raster(app.params, fin, app.bvh, height=app.height,
                           width=app.width)
            self.last_output = None
            # raster frames carry no u8 — clear it so the viewer falls
            # back to quantizing `image` (a stale ray frame here would
            # freeze the stream after an F2 toggle)
            self.last_u8 = None
        app.frame = frame.end_frame()

        # 5. picker-driven reloads (application.cpp:482-516)
        if app.model_picker.reload_requested:
            app.model_picker.reload_requested = False
            path = app.model_picker.entries[app.model_picker.selected]
            if app.load_bvh_model(path):
                app.reset_accumulation("bvh reload")
        if app.env_picker.reload_requested:
            app.env_picker.reload_requested = False
            path = app.env_picker.entries[app.env_picker.selected]
            if app.load_env_map(path):
                app.reset_accumulation("env reload")

        # 6. accumulation-reset decision (application.cpp:523-553):
        # param diff or FOV zoom flush history (movement alone does not —
        # TAA reprojection handles it)
        if params_changed(app.prev_params, app.params):
            app.reset_accumulation("params changed")
        elif inp.zoomed:
            app.reset_accumulation("fov zoom")
        app.prev_params = app.params

        inp.clear_edges()
        self.frame_count += 1
        app.record_frame_time(frames=k)
        return image

    def run(self, frames: int, dt: float = 1.0 / 60.0):
        """Headless main loop; returns the last image."""
        image = None
        for _ in range(frames):
            if self.input.quit:
                break
            image = self.step(dt)
        return image
