"""Procedural geometry, OBJ IO and world-space triangle gather (numpy).

Copies of `opengl_raytracing_tpu/scene/geometry.py`: the ground plane, UV
sphere and icosphere, the bunny-like blob that stands in for the
reference's `models/bunny_lp.obj`, a minimal OBJ reader and writer, the
model transform, and the gather that mirrors `gather_model_triangles`
(reference: src/scene/bvh.cpp:225-246).  The `_fast` forms call the
port's g++ library (native/), as the JAX package's call its own, and
run the Python and numpy forms where no g++ is on PATH.  The tests hold
every function to the original exactly.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .. import native

Mesh = Tuple[np.ndarray, np.ndarray]  # (verts [V,3] f32, faces [F,3] i32)


def make_plane(size: float = 20.0, y: float = 0.0) -> Mesh:
    """Ground quad (two triangles)."""
    s = size
    verts = np.array([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]],
                     np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return verts, faces


def make_uv_sphere(radius: float = 1.0, stacks: int = 24,
                   slices: int = 48) -> Mesh:
    vs, fs = [], []
    for i in range(stacks + 1):
        theta = np.pi * i / stacks
        for j in range(slices):
            phi = 2 * np.pi * j / slices
            vs.append([radius * np.sin(theta) * np.cos(phi),
                       radius * np.cos(theta),
                       radius * np.sin(theta) * np.sin(phi)])

    def vid(i, j):
        return i * slices + (j % slices)
    for i in range(stacks):
        for j in range(slices):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                fs.append([a, b, c])
            if i < stacks - 1:
                fs.append([b, d, c])
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


def make_icosphere(radius: float = 1.0, subdivisions: int = 3) -> Mesh:
    """Subdivided icosahedron (near-uniform triangles)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

    for _ in range(subdivisions):
        cache: dict = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            m = (verts[a] + verts[b]) / 2.0
            m /= np.linalg.norm(m)
            vlist.append(m)
            cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def make_bunny(subdivisions: int = 4) -> Mesh:
    """Bunny-like organic blob: an icosphere displaced by gaussian bumps
    (body + head + two ears + tail), 5,120 triangles at subdivisions=4."""
    verts, faces = make_icosphere(1.0, subdivisions)
    v = verts.astype(np.float64)

    def bump(center, sigma, amp):
        c = np.asarray(center, np.float64)
        c /= np.linalg.norm(c)
        d2 = np.sum((v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                                    1e-9) - c) ** 2, axis=1)
        return amp * np.exp(-d2 / (2 * sigma * sigma))

    r = np.ones(len(v))
    r += bump([0.0, 0.35, 0.9], 0.45, 0.55)      # head
    r += bump([-0.18, 0.95, 0.55], 0.16, 0.70)   # left ear
    r += bump([0.18, 0.95, 0.55], 0.16, 0.70)    # right ear
    r += bump([0.0, -0.1, -0.95], 0.25, 0.25)    # tail
    r += bump([0.0, -0.5, 0.1], 0.8, 0.15)       # belly
    v = v * r[:, None]
    v[:, 1] *= 0.95
    v[:, 2] *= 1.15
    return v.astype(np.float32), faces


def load_obj(path: str) -> Mesh:
    """Minimal OBJ reader: v / f records, triangulates polygon fans.

    Parity target: assimp import with Triangulate
    (reference: include/scene/model.h:108-115); normals/uvs are recomputed
    downstream so only positions and connectivity are kept.
    """
    verts, faces = [], []
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = tok.split("/")[0]
                    k = int(i)
                    idx.append(k - 1 if k > 0 else len(verts) + k)
                for j in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def load_obj_fast(path: str) -> Mesh:
    """OBJ load through the native C++ parser (native/), else the Python
    reader: where no g++ is on PATH, and for a file the parser refuses
    (a malformed vertex line), which the reader then raises on."""
    result = native.load_obj(path)
    return result if result is not None else load_obj(path)


def save_obj(path: str, mesh: Mesh) -> None:
    verts, faces = mesh
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# generated by opengl_raytracing_tpu\n")
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def model_transform(translate=(0.0, 0.0, 0.0), scale=1.0) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = translate
    m[0, 0] = m[1, 1] = m[2, 2] = scale
    return m


def gather_triangles(mesh: Mesh, transform: np.ndarray) -> np.ndarray:
    """Flatten an indexed mesh into world-space (v0, e1, e2) rows [T,9]."""
    verts, faces = mesh
    w = verts @ transform[:3, :3].T + transform[:3, 3]
    p0 = w[faces[:, 0]]
    p1 = w[faces[:, 1]]
    p2 = w[faces[:, 2]]
    return np.concatenate([p0, p1 - p0, p2 - p0], axis=1).astype(np.float32)


def gather_triangles_fast(mesh: Mesh, transform: np.ndarray) -> np.ndarray:
    """Triangle gather through the native C++ path (native/), else numpy
    where no g++ is on PATH.  The native gather does no bounds check, so
    a face that indexes outside the vertices raises IndexError naming the
    count first, on either route."""
    verts, faces = mesh
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise IndexError(
            f"face index out of range (verts={len(verts)}, "
            f"max index={int(faces.max())})")
    result = native.gather_triangles(mesh, transform)
    return result if result is not None else gather_triangles(mesh,
                                                              transform)
