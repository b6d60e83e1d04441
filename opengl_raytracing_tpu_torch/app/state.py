"""AppState: all engine runtime state in one place.

Counterpart of `opengl_raytracing_tpu/app/state.py` and of the
reference's god-object (reference: include/app/state.h:45-132): camera,
params, frame state, accumulation, scene assets (BVH model + env map),
mode toggles, and picker state.  The tensors (the accumulation, the BVH,
the environment table) live on the state's `device`; the rest is host
state that the frame loop threads through frames.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import List, Optional

import numpy as np

from .. import native
from ..camera import Camera
from ..constants import DEFAULT_BVH_SCALE, DEFAULT_BVH_TRANSLATE
from ..convert import env_from_numpy
from ..frame_state import FrameState
from ..models.pipeline import RenderState, render_device
from ..ops.scene import BVHDevice, prepare_bvh
from ..params import RenderParams
from ..scene.geometry import gather_triangles_fast, model_transform
from ..scene.importers import MODEL_EXTENSIONS, load_model
from ..utils.image import read_image, slice_cubemap_cross
from ..utils.log import log
from ..utils.paths import resolve_dir


@dataclasses.dataclass
class PickerState:
    """Directory-scan asset picker (reference: src/ui/gui.cpp:721-887)."""
    directory: str
    patterns: tuple
    entries: List[str] = dataclasses.field(default_factory=list)
    selected: int = -1
    reload_requested: bool = False

    def scan(self) -> List[str]:
        found: List[str] = []
        for pat in self.patterns:
            found += glob.glob(os.path.join(self.directory, pat))
        self.entries = sorted(found)
        return self.entries

    def request(self, index: int) -> None:
        if 0 <= index < len(self.entries):
            self.selected = index
            self.reload_requested = True


class AppState:
    """Everything the render loop needs between frames.  `device` is where
    the frames run: CUDA unless the caller asks for the CPU; a CUDA device
    with no card raises here."""

    def __init__(self, height: int = 1080, width: int = 1920,
                 params: Optional[RenderParams] = None, device="cuda"):
        self.device = render_device(device)
        self.height = height
        self.width = width
        self.params = params or RenderParams()
        self.prev_params = self.params
        self.camera = Camera()
        self.camera.aspect = width / height

        self.render_state = RenderState.create(height, width, self.device)
        # Host-side mirror of render_state.frame_index (+1 per ray frame,
        # 0 on reset), kept like the JAX package's, whose frame index
        # lives on the device.
        self.host_frame_index = 0
        self.frame = FrameState.initial(self.camera.view_projection(),
                                        self.camera.position)

        # Mode toggles (reference: include/app/state.h:60-76)
        self.ray_mode = True
        self.use_bvh = False
        self.show_motion = False

        # Scene assets
        self.bvh: Optional[BVHDevice] = None
        self.bvh_node_count = 0
        self.bvh_tri_count = 0
        self.env_map = None  # [6,F,F,3] float32 on `device`, or None

        # Pickers (reference: gui.cpp:721-799 models, :804-887 cubemaps).
        # The model surface covers every importer format (assimp analog,
        # reference: include/scene/model.h:108-115).
        self.model_picker = PickerState(
            resolve_dir("models"),
            tuple("*" + ext for ext in MODEL_EXTENSIONS)
            + tuple("*" + ext.upper() for ext in MODEL_EXTENSIONS))
        # same pattern surface as the reference env picker
        # (gui.cpp:806-838); all five formats decode via utils/image.py
        # (PNG / JPEG / Radiance HDR / OpenEXR scanline).
        self.env_picker = PickerState(
            resolve_dir("cubemaps"),
            ("*.png", "*.PNG", "*.jpg", "*.jpeg", "*.JPG", "*.JPEG",
             "*.hdr", "*.HDR", "*.exr", "*.EXR"))
        self.model_picker.scan()
        self.env_picker.scan()

        # Timing / metrics (reference FPS meter: gui.cpp:206-207)
        self.frame_times_ms: List[float] = []
        self.last_frame_start = time.monotonic()

    # -- asset loading with graceful degradation
    # (reference: src/app/application.cpp:482-516) --

    def load_bvh_model(self, path: str,
                       transform: Optional[np.ndarray] = None) -> bool:
        """Load a model (any of MODEL_EXTENSIONS), build the BVH and place
        it on the device; keep the previous one on failure
        (reference: src/app/application.cpp:496-499)."""
        try:
            mesh = load_model(path)
            if mesh[1].shape[0] == 0:
                raise ValueError("no faces")
            m = transform if transform is not None else model_transform(
                DEFAULT_BVH_TRANSLATE, DEFAULT_BVH_SCALE)
            self.set_bvh_from_tris(gather_triangles_fast(mesh, m))
            log("BVH", "loaded %s: %d tris, %d nodes", path,
                self.bvh_tri_count, self.bvh_node_count)
            return True
        except Exception as exc:  # keep previous BVH
            log("BVH", "failed to load %s: %s (keeping previous)", path, exc)
            return False

    def set_bvh_from_tris(self, tris: np.ndarray) -> None:
        self.bvh = prepare_bvh(tris, self.device)
        self.bvh_tri_count = int(tris.shape[0])
        self.bvh_node_count = int(self.bvh.arrays.bounds.shape[0])

    def load_env_map(self, path: str) -> bool:
        """Load a 4x3-cross image (png/jpg/jpeg/hdr/exr) as the cubemap
        table on the device; keep the previous one on failure
        (reference: src/app/application.cpp:300-304,513-515)."""
        try:
            img = read_image(path)
            # 8-bit crosses through the native slicer, as the JAX app
            # slices them; float crosses (HDR, EXR) through numpy
            faces = (native.slice_cubemap_cross(img)
                     if img.dtype == np.uint8 else None)
            if faces is None:
                faces = slice_cubemap_cross(img)
            if img.dtype == np.uint8:
                # 8-bit sources as the JAX package keeps them: integer
                # texels (round repairs the f32 divide+multiply round
                # trip), which env_from_numpy turns back into k / 255;
                # float sources (HDR, EXR) are carried as they are
                faces = np.clip(np.round(faces * 255.0), 0.0,
                                255.0).astype(np.uint8)
            self.env_map = env_from_numpy(faces, self.device)
            log("ENV", "loaded cubemap %s (%dx%d faces)", path,
                faces.shape[1], faces.shape[2])
            return True
        except Exception as exc:
            log("ENV", "failed to load %s: %s (keeping previous)", path, exc)
            return False

    def resize(self, height: int, width: int) -> None:
        """Recreate size-dependent buffers and keep camera aspect in sync
        (reference resize handler: src/app/application.cpp:216-231)."""
        self.height, self.width = height, width
        self.camera.aspect = width / height
        self.render_state = RenderState.create(height, width, self.device)
        self.host_frame_index = 0
        self.frame = FrameState.initial(self.camera.view_projection(),
                                        self.camera.position)
        log("INIT", "resized to %dx%d (accum + gbuffer recreated)",
            width, height)

    # -- accumulation control (reference: src/render/accum.cpp:98-102) --

    def restore_render_state(self, rs: RenderState) -> None:
        """Install an externally loaded RenderState (snapshot resume),
        keeping host_frame_index in sync so the jitter sequence continues
        from the restored frame rather than restarting at 0.  Its
        accumulation is copied into the app's own (one device copy), which
        a captured frame may own (models/graph.py): resuming recaptures
        nothing."""
        if rs.accum.device != self.device:
            raise ValueError(f"render state is on {rs.accum.device}, the "
                             f"app on {self.device}")
        accum = self.render_state.accum
        if accum.shape == rs.accum.shape:
            rs = RenderState(accum.copy_(rs.accum), rs.frame_index)
        self.render_state = rs
        self.host_frame_index = int(rs.frame_index)

    def reset_accumulation(self, reason: str = "") -> None:
        self.render_state = self.render_state.reset()
        self.host_frame_index = 0
        if reason:
            log("ACCUM", "reset (%s)", reason)

    def record_frame_time(self, frames: int = 1) -> float:
        """`frames` > 1 when one step chained several accumulation frames
        (turbo): the stats window carries per-FRAME times so the fps
        overlay reports accumulation frames/s, not steps/s."""
        now = time.monotonic()
        dt = (now - self.last_frame_start) * 1e3
        self.last_frame_start = now
        self.frame_times_ms.extend([dt / frames] * frames)
        while len(self.frame_times_ms) > 240:
            self.frame_times_ms.pop(0)
        return dt

    @property
    def fps(self) -> float:
        if not self.frame_times_ms:
            return 0.0
        avg = np.mean(self.frame_times_ms[-60:])
        return 1000.0 / max(avg, 1e-6)
