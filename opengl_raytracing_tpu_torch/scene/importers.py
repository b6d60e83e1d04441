"""Multi-format model import: OBJ, STL, PLY, glTF 2.0 (.gltf/.glb),
Collada (.dae), 3D Studio (.3ds), FBX (binary + 7.x ASCII).

A copy of `opengl_raytracing_tpu/scene/importers.py` (numpy, json, xml
and zlib only); OBJ goes through the Python reader of `geometry.py`.

Parity target: the reference imports models through assimp's ReadFile
with Triangulate | JoinIdenticalVertices (reference:
include/scene/model.h:108-115), which accepts many formats; only
positions and connectivity matter downstream (normals are recomputed
from the triangle edges in the BVH gather).  `load_model` dispatches by
extension; every loader returns the package Mesh contract
(verts [V,3] f32, faces [F,3] i32) with polygon fans triangulated,
exactly like the OBJ path (scene/geometry.py:135-158).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .geometry import Mesh, load_obj_fast

MODEL_EXTENSIONS = (".obj", ".stl", ".ply", ".gltf", ".glb", ".dae",
                    ".3ds", ".fbx")


def load_model(path: str) -> Mesh:
    """Load any supported model format by extension.

    Raises ValueError on unsupported extensions and on malformed files
    (the caller keeps the previous model on failure, same graceful
    degradation as the reference's BVH-load failure path,
    reference: src/app/application.cpp:496-499)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj_fast(path)
    if ext == ".stl":
        return load_stl(path)
    if ext == ".ply":
        return load_ply(path)
    if ext in (".gltf", ".glb"):
        return load_gltf(path)
    if ext == ".dae":
        return load_dae(path)
    if ext == ".3ds":
        return load_3ds(path)
    if ext == ".fbx":
        return load_fbx(path)
    raise ValueError(f"unsupported model format: {ext!r} ({path})")


# -----------------------------------------------------------------------------
# STL (binary + ASCII)
# -----------------------------------------------------------------------------

def load_stl(path: str) -> Mesh:
    """STL reader.  Binary STL stores 50-byte records (normal + 3 verts +
    attribute count); ASCII starts with 'solid' and vertex lines.  STL has
    no shared vertices, so faces index a flat 3T vertex list."""
    with open(path, "rb") as fh:
        head = fh.read(84)
        if len(head) >= 84:
            (count,) = struct.unpack("<I", head[80:84])
            expect = 84 + count * 50
            if os.path.getsize(path) == expect and count > 0:
                fh.seek(84)
                raw = np.frombuffer(fh.read(count * 50), np.uint8)
                rec = raw.reshape(count, 50)
                floats = rec[:, 0:48].copy().view("<f4").reshape(count, 12)
                verts = floats[:, 3:12].reshape(count * 3, 3)
                faces = np.arange(count * 3, dtype=np.int32).reshape(-1, 3)
                return verts.astype(np.float32), faces
    # ASCII fallback
    verts = []
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            t = line.split()
            if len(t) == 4 and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    if not verts or len(verts) % 3:
        raise ValueError(f"malformed STL: {path}")
    v = np.asarray(verts, np.float32)
    return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)


def save_stl(path: str, mesh: Mesh) -> None:
    """Binary STL writer (fixture/export helper)."""
    verts, faces = mesh
    tris = verts[faces]                                  # [F,3,3]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80)
        fh.write(struct.pack("<I", len(faces)))
        for i in range(len(faces)):
            fh.write(np.concatenate([n[i], tris[i].reshape(-1)])
                     .astype("<f4").tobytes())
            fh.write(b"\0\0")


# -----------------------------------------------------------------------------
# PLY (ASCII + binary_little_endian)
# -----------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> Mesh:
    """PLY reader: ascii and binary_little_endian, vertex x/y/z + face
    vertex index lists (fans triangulated)."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_kind, dtype(s), name)])
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"truncated PLY header: {path}")
            t = line.decode("ascii", "replace").split()
            if not t or t[0] == "comment":
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                elements.append((t[1], int(t[2]), []))
            elif t[0] == "property":
                if t[1] == "list":
                    elements[-1][2].append(
                        ("list", (_PLY_TYPES[t[2]], _PLY_TYPES[t[3]]), t[4]))
                else:
                    elements[-1][2].append(
                        ("scalar", _PLY_TYPES[t[1]], t[2]))
            elif t[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format {fmt!r}: {path}")
        verts, faces = None, []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [fh.readline().split() for _ in range(count)]
                if name == "vertex":
                    cols = {p[2]: k for k, p in enumerate(props)}
                    verts = np.asarray(
                        [[float(r[cols["x"]]), float(r[cols["y"]]),
                          float(r[cols["z"]])] for r in rows], np.float32)
                elif name == "face":
                    for r in rows:
                        idx = [int(x) for x in r[1:1 + int(r[0])]]
                        for j in range(1, len(idx) - 1):
                            faces.append([idx[0], idx[j], idx[j + 1]])
                continue
            # binary_little_endian
            if name == "vertex" and all(p[0] == "scalar" for p in props):
                dt = np.dtype([(p[2], "<" + p[1]) for p in props])
                arr = np.frombuffer(fh.read(dt.itemsize * count), dt)
                verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                 axis=1).astype(np.float32)
            elif name == "face":
                cnt_t, idx_t = props[0][1]
                cnt_dt = np.dtype("<" + cnt_t)
                idx_dt = np.dtype("<" + idx_t)
                for _ in range(count):
                    (k,) = np.frombuffer(fh.read(cnt_dt.itemsize), cnt_dt)
                    idx = np.frombuffer(fh.read(idx_dt.itemsize * int(k)),
                                        idx_dt)
                    for j in range(1, len(idx) - 1):
                        faces.append([int(idx[0]), int(idx[j]),
                                      int(idx[j + 1])])
            elif all(p[0] == "scalar" for p in props):
                # unknown fixed-size element: skip in one read
                width = sum(np.dtype("<" + p[1]).itemsize for p in props)
                fh.read(width * count)
            else:
                # element with list properties: width is data-dependent, so
                # walk row by row honoring each list count (a scalar-only
                # skip would desync the stream for every later element);
                # vertex elements still yield x/y/z from their scalars
                rows = []
                for _ in range(count):
                    vals = {}
                    for p in props:
                        if p[0] == "scalar":
                            dt = np.dtype("<" + p[1])
                            (v,) = np.frombuffer(fh.read(dt.itemsize), dt)
                            vals[p[2]] = v
                        else:
                            cnt_t, item_t = p[1]
                            cnt_dt = np.dtype("<" + cnt_t)
                            (k,) = np.frombuffer(fh.read(cnt_dt.itemsize),
                                                 cnt_dt)
                            fh.read(np.dtype("<" + item_t).itemsize * int(k))
                    rows.append(vals)
                if name == "vertex":
                    verts = np.asarray([[r["x"], r["y"], r["z"]]
                                        for r in rows], np.float32)
        if verts is None or not faces:
            raise ValueError(f"PLY missing vertex/face data: {path}")
        return verts, np.asarray(faces, np.int32)


def save_ply(path: str, mesh: Mesh, binary: bool = True) -> None:
    """PLY writer (fixture/export helper)."""
    verts, faces = mesh
    head = ("ply\nformat %s 1.0\nelement vertex %d\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face %d\nproperty list uchar int vertex_indices\n"
            "end_header\n" % (
                "binary_little_endian" if binary else "ascii",
                len(verts), len(faces)))
    with open(path, "wb") as fh:
        fh.write(head.encode("ascii"))
        if binary:
            fh.write(verts.astype("<f4").tobytes())
            for f in faces:
                fh.write(struct.pack("<B3i", 3, *[int(x) for x in f]))
        else:
            for v in verts:
                fh.write(f"{v[0]} {v[1]} {v[2]}\n".encode("ascii"))
            for f in faces:
                fh.write(f"3 {f[0]} {f[1]} {f[2]}\n".encode("ascii"))


# -----------------------------------------------------------------------------
# glTF 2.0 (.gltf JSON + external/base64 buffers, .glb binary container)
# -----------------------------------------------------------------------------

_GLTF_CTYPE = {5120: "i1", 5121: "u1", 5122: "i2", 5123: "u2",
               5125: "u4", 5126: "f4"}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _gltf_node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float64)
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m = np.block([[r @ m[:3, :3], np.zeros((3, 1))],
                      [np.zeros((1, 3)), np.ones((1, 1))]])
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def load_gltf(path: str) -> Mesh:
    """glTF 2.0 reader: TRIANGLES primitives, POSITION + indices, node
    hierarchy transforms baked into world-space vertices.  Supports .glb
    containers, external .bin buffers, and data: URIs."""
    with open(path, "rb") as fh:
        blob = fh.read()
    bin_chunk = None
    if blob[:4] == b"glTF":  # GLB container
        if len(blob) < 12:
            raise ValueError(f"truncated GLB: {path}")
        off = 12
        gltf = None
        while off + 8 <= len(blob):
            (clen, ctype) = struct.unpack_from("<II", blob, off)
            data = blob[off + 8:off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                gltf = json.loads(data.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = data
            off += 8 + clen + (-clen % 4 if ctype == 0x4E4F534A else 0)
        if gltf is None:
            raise ValueError(f"GLB without JSON chunk: {path}")
    else:
        gltf = json.loads(blob.decode("utf-8"))

    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(os.path.dirname(path), uri), "rb") as fh:
                buffers.append(fh.read())

    def read_accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dt = np.dtype("<" + _GLTF_CTYPE[acc["componentType"]])
        ncomp = _GLTF_NCOMP[acc["type"]]
        start = (view.get("byteOffset", 0) + acc.get("byteOffset", 0))
        buf = buffers[view["buffer"]]
        stride = view.get("byteStride") or dt.itemsize * ncomp
        count = acc["count"]
        if stride == dt.itemsize * ncomp:
            a = np.frombuffer(buf, dt, count * ncomp, start)
            return a.reshape(count, ncomp)
        rows = np.frombuffer(buf, np.uint8, stride * count, start)
        rows = rows.reshape(count, stride)[:, :dt.itemsize * ncomp]
        return rows.copy().view(dt).reshape(count, ncomp)

    all_v, all_f = [], []

    def walk(node_idx, parent_m):
        node = gltf["nodes"][node_idx]
        m = parent_m @ _gltf_node_matrix(node)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:  # TRIANGLES only
                    continue
                pos = read_accessor(prim["attributes"]["POSITION"])
                pos = pos.astype(np.float64)
                w = pos @ m[:3, :3].T + m[:3, 3]
                if "indices" in prim:
                    idx = read_accessor(prim["indices"]).reshape(-1)
                else:
                    idx = np.arange(len(pos))
                base = sum(len(v) for v in all_v)
                all_v.append(w.astype(np.float32))
                all_f.append((idx.reshape(-1, 3) + base).astype(np.int32))
        for child in node.get("children", []):
            walk(child, m)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [])
    roots = (scenes[scene_idx]["nodes"] if scenes
             else list(range(len(gltf.get("nodes", [])))))
    for r in roots:
        walk(r, np.eye(4))
    if not all_v or not all_f:
        raise ValueError(f"glTF contains no triangle geometry: {path}")
    return np.concatenate(all_v), np.concatenate(all_f)


def save_glb(path: str, mesh: Mesh) -> None:
    """Minimal GLB writer (fixture/export helper): one indexed
    TRIANGLES primitive."""
    verts, faces = mesh
    vbytes = verts.astype("<f4").tobytes()
    ibytes = faces.astype("<u4").reshape(-1).tobytes()
    binv = vbytes + ibytes
    binv += b"\0" * (-len(binv) % 4)
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts),
             "type": "VEC3",
             "min": [float(x) for x in verts.min(axis=0)],
             "max": [float(x) for x in verts.max(axis=0)]},
            {"bufferView": 1, "componentType": 5125,
             "count": faces.size, "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vbytes)},
            {"buffer": 0, "byteOffset": len(vbytes),
             "byteLength": len(ibytes)}],
        "buffers": [{"byteLength": len(binv)}],
    }
    js = json.dumps(gltf).encode("utf-8")
    js += b" " * (-len(js) % 4)
    total = 12 + 8 + len(js) + 8 + len(binv)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sII", b"glTF", 2, total))
        fh.write(struct.pack("<II", len(js), 0x4E4F534A))
        fh.write(js)
        fh.write(struct.pack("<II", len(binv), 0x004E4942))
        fh.write(binv)


# -----------------------------------------------------------------------------
# Collada 1.4/1.5 (.dae): XML geometry libraries + visual-scene node
# transforms; namespace-agnostic (matches by local element name).
# -----------------------------------------------------------------------------

def _dae_local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _dae_floats(text) -> np.ndarray:
    return np.asarray((text or "").split(), np.float64)


def _dae_node_matrix(node) -> np.ndarray:
    """Compose a node's transform elements in document order
    (Collada spec: transforms apply in the order written)."""
    m = np.eye(4)
    for el in node:
        tag = _dae_local(el.tag)
        if tag == "matrix":
            m = m @ _dae_floats(el.text).reshape(4, 4)
        elif tag == "translate":
            t = np.eye(4)
            t[:3, 3] = _dae_floats(el.text)[:3]
            m = m @ t
        elif tag == "scale":
            s = np.eye(4)
            s[:3, :3] = np.diag(_dae_floats(el.text)[:3])
            m = m @ s
        elif tag == "rotate":
            x, y, z, deg = _dae_floats(el.text)[:4]
            axis = np.asarray([x, y, z], np.float64)
            n = np.linalg.norm(axis)
            if n > 0:
                axis /= n
                a = np.radians(deg)
                c, s_ = np.cos(a), np.sin(a)
                kx, ky, kz = axis
                k = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
                r = np.eye(4)
                r[:3, :3] = np.eye(3) * c + s_ * k + (1 - c) * np.outer(
                    axis, axis)
                m = m @ r
    return m


def _dae_geometry_mesh(geo) -> Mesh | None:
    """One <geometry>: POSITION source + triangles/polylist prims."""
    mesh_el = next((el for el in geo.iter()
                    if _dae_local(el.tag) == "mesh"), None)
    if mesh_el is None:
        return None
    sources = {}
    for src in mesh_el:
        if _dae_local(src.tag) != "source":
            continue
        fa = next((el for el in src if _dae_local(el.tag) == "float_array"),
                  None)
        if fa is not None:
            sources["#" + src.get("id", "")] = _dae_floats(fa.text)
    # <vertices> maps its id to the POSITION source
    vert_src = {}
    for el in mesh_el:
        if _dae_local(el.tag) == "vertices":
            for inp in el:
                if (_dae_local(inp.tag) == "input"
                        and inp.get("semantic") == "POSITION"):
                    vert_src["#" + el.get("id", "")] = inp.get("source")
    all_v, all_f = [], []
    for prim in mesh_el:
        kind = _dae_local(prim.tag)
        if kind not in ("triangles", "polylist"):
            continue
        inputs = [el for el in prim if _dae_local(el.tag) == "input"]
        v_off, v_src = 0, None
        stride = 1
        for inp in inputs:
            off = int(inp.get("offset", 0))
            stride = max(stride, off + 1)
            if inp.get("semantic") == "VERTEX":
                v_off = off
                v_src = vert_src.get(inp.get("source"), inp.get("source"))
        if v_src is None or v_src not in sources:
            continue
        verts = sources[v_src].reshape(-1, 3).astype(np.float32)
        p_el = next((el for el in prim if _dae_local(el.tag) == "p"), None)
        if p_el is None:
            continue
        p = np.asarray((p_el.text or "").split(), np.int64)
        vidx = p.reshape(-1, stride)[:, v_off]
        base = sum(len(v) for v in all_v)
        faces = []
        if kind == "triangles":
            faces = vidx.reshape(-1, 3)
        else:  # polylist: <vcount> per polygon, fan-triangulated
            vc_el = next((el for el in prim
                          if _dae_local(el.tag) == "vcount"), None)
            vcount = np.asarray((vc_el.text or "").split(), np.int64)
            tri = []
            c = 0
            for n in vcount:
                for j in range(1, int(n) - 1):
                    tri.append([vidx[c], vidx[c + j], vidx[c + j + 1]])
                c += int(n)
            faces = np.asarray(tri, np.int64).reshape(-1, 3)
        all_v.append(verts)
        all_f.append((faces + base).astype(np.int32))
    if not all_v:
        return None
    return np.concatenate(all_v), np.concatenate(all_f)


def load_dae(path: str) -> Mesh:
    """Collada reader: geometry libraries instanced through the visual
    scene's node hierarchy (transforms baked), polylists triangulated,
    Z_UP assets rotated into the package's Y-up convention the way
    assimp's collada importer does."""
    import xml.etree.ElementTree as ET
    root = ET.parse(path).getroot()
    geoms = {}
    for geo in root.iter():
        if _dae_local(geo.tag) == "geometry" and geo.get("id"):
            m = _dae_geometry_mesh(geo)
            if m is not None:
                geoms["#" + geo.get("id")] = m

    up = next((el for el in root.iter()
               if _dae_local(el.tag) == "up_axis"), None)
    up_m = np.eye(4)
    if up is not None and (up.text or "").strip() == "Z_UP":
        up_m = np.asarray([[1, 0, 0, 0], [0, 0, 1, 0],
                           [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)
    elif up is not None and (up.text or "").strip() == "X_UP":
        up_m = np.asarray([[0, 1, 0, 0], [-1, 0, 0, 0],
                           [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)

    all_v, all_f = [], []

    def emit(mesh, m):
        verts, faces = mesh
        w = verts.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        base = sum(len(v) for v in all_v)
        all_v.append(w.astype(np.float32))
        all_f.append(faces + np.int32(base))

    def walk(node, parent_m):
        m = parent_m @ _dae_node_matrix(node)
        for el in node:
            tag = _dae_local(el.tag)
            if tag == "instance_geometry":
                g = geoms.get(el.get("url", ""))
                if g is not None:
                    emit(g, m)
            elif tag == "node":
                walk(el, m)

    scenes = [el for el in root.iter()
              if _dae_local(el.tag) == "visual_scene"]
    for vs in scenes:
        for el in vs:
            if _dae_local(el.tag) == "node":
                walk(el, up_m)
    if not all_v:
        # no scene instancing: import the bare geometry libraries
        for g in geoms.values():
            emit(g, up_m)
    if not all_v:
        raise ValueError(f"Collada contains no triangle geometry: {path}")
    return np.concatenate(all_v), np.concatenate(all_f)


def save_dae(path: str, mesh: Mesh) -> None:
    """Minimal Collada writer (fixture/export helper): one Y_UP geometry
    instanced by one scene node."""
    verts, faces = mesh
    vtxt = " ".join(f"{x:.9g}" for x in np.asarray(verts, np.float32)
                    .reshape(-1))
    ptxt = " ".join(str(int(i)) for i in np.asarray(faces).reshape(-1))
    doc = f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Y_UP</up_axis></asset>
  <library_geometries>
    <geometry id="shape"><mesh>
      <source id="pos"><float_array id="posarr" count="{verts.size}">{vtxt}</float_array>
        <technique_common><accessor source="#posarr" count="{len(verts)}" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/><param name="Z" type="float"/>
        </accessor></technique_common></source>
      <vertices id="vtx"><input semantic="POSITION" source="#pos"/></vertices>
      <triangles count="{len(faces)}"><input semantic="VERTEX" source="#vtx" offset="0"/>
        <p>{ptxt}</p></triangles>
    </mesh></geometry>
  </library_geometries>
  <library_visual_scenes><visual_scene id="scene">
    <node id="n0"><instance_geometry url="#shape"/></node>
  </visual_scene></library_visual_scenes>
  <scene><instance_visual_scene url="#scene"/></scene>
</COLLADA>
"""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(doc)


# -----------------------------------------------------------------------------
# 3D Studio (.3ds): chunked binary; vertex (0x4110) + face (0x4120)
# arrays per trimesh, multiple objects concatenated.
# -----------------------------------------------------------------------------

_3DS_MAIN = 0x4D4D
_3DS_EDITOR = 0x3D3D
_3DS_OBJECT = 0x4000
_3DS_TRIMESH = 0x4100
_3DS_VERTS = 0x4110
_3DS_FACES = 0x4120


def load_3ds(path: str) -> Mesh:
    """3DS reader: walks the chunk tree, collects every trimesh's vertex
    and face arrays (coordinates used as stored, like simple exporters
    write them)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if len(blob) < 6 or struct.unpack_from("<H", blob, 0)[0] != _3DS_MAIN:
        raise ValueError(f"not a 3DS file: {path}")
    meshes = []  # one {verts, faces} dict PER trimesh chunk

    def walk(start, end, scope=None):
        pos = start
        while pos + 6 <= end:
            cid, clen = struct.unpack_from("<HI", blob, pos)
            if clen < 6 or pos + clen > end:
                raise ValueError(f"malformed 3DS chunk at {pos}: {path}")
            body = pos + 6
            if cid in (_3DS_MAIN, _3DS_EDITOR):
                walk(body, pos + clen)
            elif cid == _3DS_TRIMESH:
                # verts/faces pair within ONE trimesh scope (positional
                # pairing across objects would mispair after a
                # point-cloud trimesh with no face chunk)
                mesh = {}
                meshes.append(mesh)
                walk(body, pos + clen, scope=mesh)
            elif cid == _3DS_OBJECT:
                # skip the asciiz object name, then recurse
                name_end = blob.index(b"\0", body) + 1
                walk(name_end, pos + clen)
            elif cid == _3DS_VERTS and scope is not None:
                (n,) = struct.unpack_from("<H", blob, body)
                v = np.frombuffer(blob, "<f4", n * 3, body + 2)
                scope["verts"] = v.reshape(n, 3).astype(np.float32)
            elif cid == _3DS_FACES and scope is not None:
                (n,) = struct.unpack_from("<H", blob, body)
                f = np.frombuffer(blob, "<u2", n * 4, body + 2)
                scope["faces"] = f.reshape(n, 4)[:, :3].astype(np.int32)
            pos += clen

    walk(0, len(blob))
    verts, faces, base = [], [], 0
    for m in meshes:
        if "verts" not in m or "faces" not in m:
            continue  # point clouds / lines contribute no triangles
        if m["faces"].size and int(m["faces"].max()) >= len(m["verts"]):
            raise ValueError(f"3DS face index out of range: {path}")
        verts.append(m["verts"])
        faces.append(m["faces"] + base)
        base += len(m["verts"])
    if not verts or not any(len(f) for f in faces):
        raise ValueError(f"3DS contains no triangle geometry: {path}")
    return np.concatenate(verts), np.concatenate(faces)


def save_3ds(path: str, mesh: Mesh) -> None:
    """Minimal 3DS writer (fixture/export helper): one named trimesh."""
    verts, faces = mesh
    if len(verts) > 0xFFFF or len(faces) > 0xFFFF:
        raise ValueError("3DS chunks hold at most 65535 verts/faces")
    vch = (struct.pack("<HIH", _3DS_VERTS, 6 + 2 + verts.size * 4,
                       len(verts))
           + np.asarray(verts, "<f4").tobytes())
    fdata = np.zeros((len(faces), 4), "<u2")
    fdata[:, :3] = np.asarray(faces, np.int64)
    fch = (struct.pack("<HIH", _3DS_FACES, 6 + 2 + fdata.size * 2,
                       len(faces)) + fdata.tobytes())
    tri = struct.pack("<HI", _3DS_TRIMESH, 6 + len(vch) + len(fch)) \
        + vch + fch
    obj = struct.pack("<HI", _3DS_OBJECT, 6 + 5 + len(tri)) \
        + b"mesh\0" + tri
    ed = struct.pack("<HI", _3DS_EDITOR, 6 + len(obj)) + obj
    with open(path, "wb") as fh:
        fh.write(struct.pack("<HI", _3DS_MAIN, 6 + len(ed)) + ed)


# -----------------------------------------------------------------------------
# FBX (Kaydara binary 7.x + 7.x ASCII): Geometry nodes' Vertices +
# PolygonVertexIndex, polygons fan-triangulated.  Model-node transform
# inheritance is NOT applied (most exporters bake world coordinates for
# static meshes; assimp parity for positions+connectivity only, like
# the other importers).
# -----------------------------------------------------------------------------

_FBX_MAGIC = b"Kaydara FBX Binary  \x00"


def _fbx_read_props(blob, pos, n):
    """Read n binary properties; returns (values, new_pos)."""
    import zlib
    scalars = {b"Y": ("<h", 2), b"C": ("<B", 1), b"I": ("<i", 4),
               b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8)}
    arrays = {b"f": "<f4", b"d": "<f8", b"l": "<i8", b"i": "<i4",
              b"b": "u1"}
    vals = []
    for _ in range(n):
        t = blob[pos:pos + 1]
        pos += 1
        if t in scalars:
            fmt, sz = scalars[t]
            vals.append(struct.unpack_from(fmt, blob, pos)[0])
            pos += sz
        elif t in arrays:
            ln, enc, clen = struct.unpack_from("<III", blob, pos)
            pos += 12
            raw = blob[pos:pos + clen]
            pos += clen
            if enc == 1:
                raw = zlib.decompress(raw)
            vals.append(np.frombuffer(raw, arrays[t], ln))
        elif t in (b"S", b"R"):
            (ln,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            vals.append(blob[pos:pos + ln])
            pos += ln
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return vals, pos


def _fbx_walk_binary(blob, pos, end, big, out):
    """Recursive binary node-record walk; collects
    (name, props, children) into out."""
    hdr = "<QQQB" if big else "<IIIB"
    hsz = 25 if big else 13
    while pos + hsz <= end:
        end_off, n_props, _plen, name_len = struct.unpack_from(
            hdr, blob, pos)
        if end_off == 0:  # null sentinel terminates a nested list
            return pos + hsz
        if end_off <= pos or end_off > len(blob):
            # corrupt record: a non-advancing end offset would spin this
            # loop forever (same guard class as load_3ds's chunk check)
            raise ValueError(f"malformed FBX record at {pos}")
        name = blob[pos + hsz:pos + hsz + name_len].decode(
            "ascii", "replace")
        ppos = pos + hsz + name_len
        props, cpos = _fbx_read_props(blob, ppos, n_props)
        children = []
        if cpos < end_off:
            _fbx_walk_binary(blob, cpos, end_off, big, children)
        out.append((name, props, children))
        pos = end_off
    return pos


def _fbx_triangulate(pvi: np.ndarray):
    """PolygonVertexIndex -> [F,3] faces: a negative entry is the
    polygon's final vertex, stored as ~index; fans triangulate."""
    faces = []
    poly = []
    for raw in pvi:
        i = int(raw)
        if i < 0:
            poly.append(~i)
            for j in range(1, len(poly) - 1):
                faces.append([poly[0], poly[j], poly[j + 1]])
            poly = []
        else:
            poly.append(i)
    return np.asarray(faces, np.int64).reshape(-1, 3)


def _fbx_ascii_meshes(text: str):
    """Minimal 7.x ASCII scan: every Vertices/PolygonVertexIndex 'a:'
    payload pair in file order (ASCII FBX writes `Vertices: *N { a:
    csv... }`)."""
    import re
    pat = re.compile(r"(Vertices|PolygonVertexIndex)\s*:\s*\*\d+\s*{"
                     r"\s*a\s*:([^}]*)}", re.S)
    verts, idx = [], []
    for m in pat.finditer(text):
        nums = m.group(2).replace("\n", "").split(",")
        if m.group(1) == "Vertices":
            verts.append(np.asarray([float(x) for x in nums if x.strip()],
                                    np.float64))
        else:
            idx.append(np.asarray([int(x) for x in nums if x.strip()],
                                  np.int64))
    return list(zip(verts, idx))


def load_fbx(path: str) -> Mesh:
    """FBX reader (binary + 7.x ASCII): every Geometry node's vertex
    cloud + polygon index list, fan-triangulated and concatenated."""
    with open(path, "rb") as fh:
        blob = fh.read()
    pairs = []
    if blob[:len(_FBX_MAGIC)] == _FBX_MAGIC:
        (version,) = struct.unpack_from("<I", blob, 23)
        nodes = []
        _fbx_walk_binary(blob, 27, len(blob), version >= 7500, nodes)

        def find_geoms(ns):
            for name, props, children in ns:
                if name == "Geometry" or name == "Model" and any(
                        c[0] == "Vertices" for c in children):
                    v = next((p[1][0] for p in children
                              if p[0] == "Vertices" and p[1]), None)
                    i = next((p[1][0] for p in children
                              if p[0] == "PolygonVertexIndex" and p[1]),
                             None)
                    if v is not None and i is not None:
                        pairs.append((np.asarray(v, np.float64),
                                      np.asarray(i, np.int64)))
                find_geoms(children)

        find_geoms(nodes)
    else:
        pairs = _fbx_ascii_meshes(blob.decode("utf-8", "replace"))

    all_v, all_f = [], []
    for v, i in pairs:
        verts = v.reshape(-1, 3).astype(np.float32)
        faces = _fbx_triangulate(i)
        base = sum(len(x) for x in all_v)
        all_v.append(verts)
        all_f.append((faces + base).astype(np.int32))
    if not all_v or not any(len(f) for f in all_f):
        raise ValueError(f"FBX contains no triangle geometry: {path}")
    return np.concatenate(all_v), np.concatenate(all_f)


def save_fbx(path: str, mesh: Mesh) -> None:
    """Minimal binary-FBX writer (fixture/export helper): one Geometry
    node under Objects, version 7400 (32-bit record headers)."""
    verts, faces = mesh
    pvi = np.asarray(faces, np.int64).copy()
    pvi[:, 2] = ~pvi[:, 2]

    def prop_arr(tchar, arr, dtype):
        a = np.asarray(arr, dtype).tobytes()
        return tchar + struct.pack("<III", arr.size, 0, len(a)) + a

    # record end-offsets are absolute, so assemble depth-first tracking
    # each record's base position
    def pack(name, props_b, nprops, children_recs, base):
        name_b = name.encode("ascii")
        pos = base + 13 + len(name_b) + len(props_b)
        kids = b""
        for cn, cp, cnp, cc in children_recs:
            kid = pack(cn, cp, cnp, cc, pos)
            kids += kid
            pos += len(kid)
        if children_recs:
            kids += b"\0" * 13
            pos += 13
        return struct.pack("<IIIB", pos, nprops, len(props_b),
                           len(name_b)) + name_b + props_b + kids

    vprop = prop_arr(b"d", np.asarray(verts, np.float64).reshape(-1),
                     "<f8")
    iprop = prop_arr(b"i", pvi.reshape(-1), "<i4")
    geometry = ("Geometry", b"", 0, [("Vertices", vprop, 1, []),
                                     ("PolygonVertexIndex", iprop, 1, [])])
    objects = ("Objects", b"", 0, [geometry])
    head = _FBX_MAGIC + b"\x1a\x00" + struct.pack("<I", 7400)
    body = pack(*objects, base=len(head))
    with open(path, "wb") as fh:
        fh.write(head + body + b"\0" * 13)
