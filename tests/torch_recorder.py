"""A recorder of what a frame dispatches, for the tests of the frames one
CUDA graph captures (tests/test_torch_graph.py: the frame;
tests/test_torch_band_graph.py: the band step and the raster preview).

A captured frame is valid for every frame index, camera and data value
only if its operations, and every host argument they take, are the same
whatever those are.  `recording` runs a frame under a TorchDispatchMode
that notes every ATen operation with its host arguments, and every
kernel wrapper call with the host arguments its launch would take (the
argument structs' bytes, their pointers aside), the wrappers running
their plain versions (the CPU route) out of the record.  It also notes
the storage of every tensor an operation reads (`storages`), so a test
can tell which parameter block the frame read."""

import contextlib
import ctypes

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from opengl_raytracing_tpu_torch.ops import (an_cuda, an_shade_cuda,
                                             an_trace_cuda, bvh_cuda,
                                             hit_mix_cuda, svgf_cuda)

# ATen operations that read a device value on the host: a captured frame
# makes none
HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
              "aten::lift_fresh")


def _host(x):
    """A record of `x` that tells frames apart on host values only:
    tensors by dtype and shape, everything else by value."""
    if isinstance(x, torch.Tensor):
        return ("tensor", x.dtype, tuple(x.shape))
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(_host(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _host(v)) for k, v in x.items()))
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class Recorder(TorchDispatchMode):
    """Every ATen operation (its schema name and host arguments) and every
    kernel wrapper call (`note`), outside `paused()`; and the storages of
    the operations' tensor arguments (`storages`, their data pointers)."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.storages = set()
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def note(self, *entry):
        if not self._paused:
            self.ops.append(entry)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._paused:
            self.note(func._schema.name, _host(args), _host(kwargs))
            self.storages.update(t.untyped_storage().data_ptr()
                                 for t in _tensors((args, kwargs)))
        return func(*args, **kwargs)


def _zero_pointers(args):
    """Zero every device pointer of a ctypes struct, nested structs'
    included, in place; a PixelGrid is zeroed whole."""
    for name, kind in type(args)._fields_:
        if kind is ctypes.c_void_p:
            setattr(args, name, None)
        elif kind is bvh_cuda.cuda_lib.PixelGrid:
            setattr(args, name, kind())
        elif isinstance(kind, type) and issubclass(kind, ctypes.Structure):
            _zero_pointers(getattr(args, name))


def _struct(args):
    """An argument struct's bytes with its device pointers zeroed (they
    differ between frames where each frame has its own block; in a
    captured frame they are the static block's)."""
    args = type(args).from_buffer_copy(bytes(args))
    _zero_pointers(args)
    return bytes(args)


def _modes(shape, *inputs):
    """How the analytic scene's kernels would read each input (x, width),
    None for an absent one: an_trace_cuda.lane_input's row mode."""
    return tuple(None if x is None else an_trace_cuda.lane_input(
        x, shape, w, x.dtype, x.device, "x")[0].mode for x, w in inputs)


@contextlib.contextmanager
def recording(monkeypatch):
    """A Recorder with the kernels' wrappers stubbed: each notes the host
    arguments its launch would take and runs its plain version (the CPU
    route) out of the record."""
    rec = Recorder()

    def stub(module, name, host_args):
        orig = getattr(module, name)

        def call(*args, **kw):
            with rec.paused():
                noted = host_args(*args, **kw)
                out = orig(*args, **kw)
            rec.note("kernel", name, noted)
            return out
        monkeypatch.setattr(module, name, call)

    def direct(scene, h, rng_frame, frame_index, *a, **kw):
        env = an_cuda._env_table(scene, h.t.device)
        return _struct(an_cuda.scene_args(scene, rng_frame, frame_index,
                                          env)[0]), tuple(h.t.shape)

    def direct_bvh(scene, h, rng_frame, frame_index, *a, **kw):
        return _struct(an_cuda.scene_args(scene, rng_frame,
                                          frame_index)[0]), tuple(h.t.shape)

    stub(an_cuda, "direct_light", direct)
    stub(an_cuda, "direct_light_bvh", direct_bvh)
    stub(bvh_cuda, "trace_bounce",
         lambda bvh, h0, rng, seed, *a, **kw: _struct(
             bvh_cuda.bounce_args(rng, seed)[0]))
    stub(bvh_cuda, "ambient_occlusion",
         lambda bvh, h, fi, px, py, params, *a, **kw: _struct(
             bvh_cuda.ao_args(params, fi)[0]))
    stub(bvh_cuda, "trace_closest",
         lambda bvh, ro, rd, *a, **kw: (tuple(ro.shape), tuple(rd.shape)))

    # the analytic scene's kernels: their structs, flags, shapes and how
    # they would read each input (a row a lane or a pixel, one row)
    def an_trace(ro, rd, params, plp, glass, marker, eps=None, active=None):
        shape = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
        return (_struct(an_cuda.scene_struct(params)), glass, marker, eps,
                tuple(shape), _modes(shape, (ro, 3), (rd, 3), (active, 0)))

    def an_ao(scene, h, fi, px, py, active=None):
        return (_struct(an_trace_cuda.ao_args(scene.params, fi)[0]),
                _struct(an_cuda.scene_struct(scene.params)),
                tuple(h.t.shape),
                _modes(h.t.shape, (h.p, 3), (h.n, 3), (active, 0)))

    def an_bounce(scene, h0, rng, seed, px, py, active=None):
        return (_struct(an_trace_cuda.bounce_args(scene.params, rng,
                                                  seed)[0]),
                _struct(an_cuda.scene_struct(scene.params)),
                tuple(h0.t.shape),
                _modes(h0.t.shape, (h0.p, 3), (h0.n, 3), (active, 0)))

    def sky(d, params, env_map=None, active=None):
        env = an_cuda.env_table(params, env_map, d.device)
        return (_struct(an_cuda.scene_struct(params, env)),
                tuple(d.shape),
                _modes(d.shape[:-1], (d, 3), (active, 0)))

    # glass's and the mirror's rays and mix kernels: the scene's struct,
    # their constants, the shapes and input modes (the mask's last)
    def shade_struct(scene, env=None):
        return (_struct(an_cuda.scene_struct(scene.params, env)),
                bytes(an_shade_cuda.shade_consts(scene.params)))

    def rays(scene, h, wo, active):
        env = an_cuda.env_table(scene.params, scene.env_map, h.t.device)
        shape = h.t.shape
        return (shade_struct(scene, env), tuple(shape),
                _modes(shape, (h.p, 3), (h.n, 3), (wo, 3), (h.mat, 0),
                       (active, 0)))

    def mix(scene, h, mat, first, *a, active=None, out=None):
        shape = (first.k if hasattr(first, "k") else first.hit.t).shape
        return (shade_struct(scene), tuple(shape), out is not None,
                _modes(shape, (h.mat, 0), (active, 0)))

    stub(an_shade_cuda, "glass_rays",
         lambda scene, h, wo, mat=None, active=None: rays(scene, h, wo,
                                                          active))
    stub(an_shade_cuda, "mirror_ray",
         lambda scene, h, wo, active=None: rays(scene, h, wo, active))
    for name in ("glass_mix", "mirror_mix"):
        stub(an_shade_cuda, name, mix)
    # both scenes' hit-mix kernels: the scene's struct, their constants,
    # the shape, whether GI's rows are read, the input modes (the mask's
    # last)
    def bvh_mix(scene, radiance, gi=None, ao=None, active=None):
        env = an_cuda.env_table(scene.params, scene.env_map, radiance.device)
        shape = radiance.shape[:-1]
        return (_struct(an_cuda.scene_struct(scene.params, env)),
                bytes(hit_mix_cuda.mix_consts()), tuple(shape),
                gi is not None, _modes(shape, (ao, 0), (active, 0)))

    def an_mix(scene, h, radiance, gi=None, ao=None, active=None):
        shape = radiance.shape[:-1]
        return (_struct(an_cuda.scene_struct(scene.params)),
                bytes(hit_mix_cuda.mix_consts()), tuple(shape),
                gi is not None,
                _modes(shape, (h.p, 3), (h.mat, 0), (scene.cam_pos, 3),
                       (ao, 0), (active, 0)))

    stub(hit_mix_cuda, "bvh_hit_mix", bvh_mix)
    stub(hit_mix_cuda, "an_hit_mix", an_mix)
    stub(an_trace_cuda, "trace", an_trace)
    stub(an_trace_cuda, "ambient_occlusion", an_ao)
    stub(an_trace_cuda, "bounce", an_bounce)
    stub(an_trace_cuda, "sky", sky)
    # the band entry's host arguments: halo, first row, image height
    stub(svgf_cuda, "svgf_present",
         lambda *a, **kw: ("svgf_present", tuple(sorted(kw.items()))))
    stub(svgf_cuda, "tonemap", lambda *a, **kw: "tonemap")
    with rec:
        yield rec
