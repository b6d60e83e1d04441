"""Input actions: the hotkey surface of the reference as a headless API.

A copy of `opengl_raytracing_tpu/app/input.py` (host only).  Mirrors
`io::update` (reference: src/io/input.cpp:16-156):
  ESC quit, F2 ray/raster, R reset accumulation, F5 BVH toggle, F6 motion
  debug, P pointer lock, F3/arrows SPP presets 1-2-4-8-16, [ ] exposure
  x0.97 / x1.03 with clamp, WASD+QE camera movement, mouse look, scroll =
  FOV zoom.  Edge-triggered keys carry previous-state memory
  (reference: include/io/input.h:24-72).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

SPP_PRESETS = (1, 2, 4, 8, 16)
EXPOSURE_MIN, EXPOSURE_MAX = 0.05, 8.0   # reference: src/io/input.cpp:147-153
EXPOSURE_DOWN, EXPOSURE_UP = 0.97, 1.03  # reference: src/io/input.cpp


@dataclasses.dataclass
class InputState:
    """Per-frame input flags (reference: include/io/input.h:24-72)."""
    quit: bool = False
    toggled_ray_mode: bool = False
    reset_accum: bool = False
    toggled_bvh: bool = False
    toggled_motion_debug: bool = False
    toggled_pointer_lock: bool = False
    changed_spp: bool = False
    changed_exposure: bool = False
    zoomed: bool = False
    spp_per_frame: int = 1
    exposure: float = 1.0
    camera_changed_this_frame: bool = False

    def clear_edges(self) -> None:
        self.toggled_ray_mode = False
        self.reset_accum = False
        self.toggled_bvh = False
        self.toggled_motion_debug = False
        self.toggled_pointer_lock = False
        self.changed_spp = False
        self.changed_exposure = False
        self.zoomed = False
        self.camera_changed_this_frame = False


def apply_action(state: InputState, action: str, app=None) -> InputState:
    """Apply one named action to the input state (and camera, if given).

    Actions mirror the hotkeys 1:1; Application consumes the flags each
    frame exactly like the reference main loop
    (reference: src/app/application.cpp:410-440).
    """
    if action == "quit":                    # ESC
        state.quit = True
    elif action == "toggle_ray_mode":       # F2
        state.toggled_ray_mode = True
    elif action == "reset":                 # R
        state.reset_accum = True
    elif action == "toggle_bvh":            # F5
        state.toggled_bvh = True
    elif action == "toggle_motion_debug":   # F6
        state.toggled_motion_debug = True
    elif action == "toggle_pointer_lock":   # P
        state.toggled_pointer_lock = True
    elif action == "spp_cycle":             # F3: 1-2-4-8-16-1 with wrap
        # exact-match chain like the reference (input.cpp:76-84): any
        # NON-preset value (e.g. --set spp_per_frame=6) wraps to 1
        state.spp_per_frame = {1: 2, 2: 4, 4: 8, 8: 16}.get(
            state.spp_per_frame, 1)
        state.changed_spp = True
    elif action == "spp_up":                # Up: saturate at 16
        # threshold form, exact for NON-preset values too (spp=6 -> 8,
        # not nearest-preset index math; reference: input.cpp:91-106)
        old = state.spp_per_frame
        state.spp_per_frame = (2 if old < 2 else 4 if old < 4
                               else 8 if old < 8 else 16 if old < 16
                               else old)
        state.changed_spp = state.spp_per_frame != old or state.changed_spp
    elif action == "spp_down":              # Down (input.cpp:108-121)
        old = state.spp_per_frame
        state.spp_per_frame = (8 if old > 8 else 4 if old > 4
                               else 2 if old > 2 else 1)
        state.changed_spp = state.spp_per_frame != old or state.changed_spp
    elif action.startswith("spp_preset_"):  # keys 1..4 -> 2/4/8/16
        idx = int(action.rsplit("_", 1)[1])  # (reference: input.cpp:124-144)
        state.spp_per_frame = SPP_PRESETS[max(1, min(idx,
                                                     len(SPP_PRESETS) - 1))]
        state.changed_spp = True
    elif action == "exposure_down":         # [
        state.exposure = max(state.exposure * EXPOSURE_DOWN, EXPOSURE_MIN)
        state.changed_exposure = True
    elif action == "exposure_up":           # ]
        state.exposure = min(state.exposure * EXPOSURE_UP, EXPOSURE_MAX)
        state.changed_exposure = True
    elif action.startswith("move_") and app is not None:
        # WASD + QE (reference: src/io/Camera.cpp:18-33)
        kind = action.rsplit("_", 1)[1]
        fw = {"w": 1.0, "s": -1.0}.get(kind, 0.0)
        st = {"d": 1.0, "a": -1.0}.get(kind, 0.0)
        vt = {"e": 1.0, "q": -1.0}.get(kind, 0.0)
        app.camera.move(forward=fw, strafe=st, vertical=vt)
    elif action.startswith("look ") and app is not None:
        _, dx, dy = action.split()
        app.camera.look(float(dx), float(dy))
    elif action.startswith("zoom ") and app is not None:
        app.camera.zoom(float(action.split()[1]))
        state.camera_changed_this_frame = True
        state.zoomed = True
    elif (action.startswith(("move_", "look ", "zoom "))
          and app is None):
        raise ValueError(f"action {action!r} requires an app (camera)")
    else:
        raise ValueError(f"unknown action {action!r}")
    return state


ACTIONS: Dict[str, str] = {
    "ESC": "quit", "F2": "toggle_ray_mode", "R": "reset", "F5": "toggle_bvh",
    "F6": "toggle_motion_debug", "P": "toggle_pointer_lock",
    "F3": "spp_cycle", "UP": "spp_up", "DOWN": "spp_down",
    "[": "exposure_down", "]": "exposure_up",
    "W": "move_w", "A": "move_a", "S": "move_s", "D": "move_d",
    "Q": "move_q", "E": "move_e",
}
