"""opengl_raytracing_tpu_torch — the renderer in PyTorch, for NVIDIA Hopper.

A port of `opengl_raytracing_tpu` (JAX on a TPU), which stays the
reference: every module here is held against its JAX counterpart by the
`tests/test_torch_*.py` parity tests.  Plain array code is PyTorch; the
kernels are CUDA C++ in `csrc/`, built with nvcc at first use
(ops/cuda_lib.py): the BVH closest-hit and any-hit walks
(ops/bvh_cuda.py), the analytic scene's direct light and the BVH
scene's BRDF tail (ops/an_cuda.py; the analytic kernel samples the
cubemap environment itself), and the present pass, one launch with the
SVGF filter or without it (ops/svgf_cuda.py).

`render_frame` renders both scenes (the bunny BVH scene; the analytic
scene: floor, albedo, glass and mirror spheres, point-light marker) under
every preset (`baseline`, `realistic`, `full`, `heavy`): GI, AO, TAA and
SVGF on or off, one or more samples a pixel, the gradient sky or a cubemap
environment, the motion debug view.  `render_raster` is the flat-colour
raster preview.

Layout (mirrors the JAX package):
  constants.py, params.py, camera.py, sampling.py   host values and RNG
  scene/     procedural meshes, model importers (OBJ, STL, PLY, glTF,
             Collada, 3DS, FBX), triangle gather, BVH builders
  native/    the g++ host library (BVH builder, OBJ parser, triangle
             gather, cubemap slicer, PNG/HDR/JPEG codec loops), built at
             first use, with the numpy forms where no g++ is on PATH
  ops/       vector math, intersection, the analytic scene, BVH walks,
             kernel wrappers, lighting, GI and AO, TAA, SVGF, present
  models/    the frame function, the raster preview and the presets
  convert.py carries host and JAX-side state (BVH arrays, params, frame
             inputs, cubemap faces) onto the device
  utils/     image codecs (PNG, JPEG, Radiance HDR, OpenEXR) and the
             cubemap-cross loader, snapshots and presets, logging, asset
             paths, frame timers
  frame_state.py  the camera matrices of this frame and the last
  app/       the application: state, input actions, the frame loop, the
             headless CLI (`python -m opengl_raytracing_tpu_torch.app.
             headless`) and the HTTP viewer (`... .app.viewer`)

Nothing here imports JAX: the machine with the card has none.
"""

__version__ = "0.1.0"

from .constants import EPS, PI, INF
from .params import RenderParams, params_changed
from .camera import Camera
from .frame_state import FrameState
