"""The port's model importers and geometry helpers against the JAX
package's.

`opengl_raytracing_tpu_torch/scene/importers.py` and `geometry.py` are
numpy copies of the JAX package's; OBJ goes through the Python reader in
both the port's `load_obj` and `load_obj_fast` (the JAX package's `_fast`
forms call its g++ library).  Every comparison is exact: the same vertex
and face arrays, dtype for dtype, and the same bytes from each writer.
Hand-made files cover what the assets do not (glTF data URIs and node
transforms, Collada Z_UP and polylists, ASCII STL and FBX, PLY list
properties, malformed files), as tests/test_importers.py does for the JAX
package.
"""

import base64
import glob
import json
import os
import struct

import numpy as np
import pytest
import torch

from opengl_raytracing_tpu.scene import geometry as jgeo
from opengl_raytracing_tpu.scene import importers as jimp

from opengl_raytracing_tpu_torch.app.state import AppState
from opengl_raytracing_tpu_torch.constants import (DEFAULT_BVH_SCALE,
                                                   DEFAULT_BVH_TRANSLATE)
from opengl_raytracing_tpu_torch.scene import geometry as tgeo
from opengl_raytracing_tpu_torch.scene import importers as timp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = sorted(os.path.relpath(p, REPO) for p in
                glob.glob(os.path.join(REPO, "models", "*")))
XF = tgeo.model_transform(DEFAULT_BVH_TRANSLATE, DEFAULT_BVH_SCALE)


def _same_mesh(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def ref_mesh():
    return tgeo.make_icosphere(1.0, 2)


def test_model_list_covers_every_importer():
    exts = {os.path.splitext(p)[1] for p in MODELS}
    assert exts == set(timp.MODEL_EXTENSIONS) - {".gltf"}
    assert timp.MODEL_EXTENSIONS == jimp.MODEL_EXTENSIONS


@pytest.mark.parametrize("rel", MODELS)
def test_load_model_equals_jax(rel):
    path = os.path.join(REPO, rel)
    mesh = timp.load_model(path)
    _same_mesh(mesh, jimp.load_model(path))
    assert mesh[0].dtype == np.float32 and mesh[1].dtype == np.int32
    assert len(mesh[1]) > 0 and mesh[1].max() < len(mesh[0])
    tris = tgeo.gather_triangles_fast(mesh, XF)
    np.testing.assert_array_equal(tris,
                                  jgeo.gather_triangles_fast(mesh, XF))


@pytest.mark.parametrize("rel", [m for m in MODELS if m.endswith(".obj")])
def test_load_obj_equals_jax_python_reader(rel):
    path = os.path.join(REPO, rel)
    _same_mesh(tgeo.load_obj(path), jgeo.load_obj(path))
    _same_mesh(tgeo.load_obj_fast(path), jgeo.load_obj(path))


@pytest.mark.parametrize("fmt", ["obj", "stl", "ply", "ply_ascii", "glb",
                                 "dae", "3ds", "fbx"])
def test_writers_equal_jax_and_roundtrip(tmp_path, ref_mesh, fmt):
    ours, theirs = (str(tmp_path / f"{who}.{fmt.split('_')[0]}")
                    for who in ("ours", "theirs"))
    if fmt == "obj":
        tgeo.save_obj(ours, ref_mesh)
        jgeo.save_obj(theirs, ref_mesh)
    elif fmt.startswith("ply"):
        timp.save_ply(ours, ref_mesh, binary=fmt == "ply")
        jimp.save_ply(theirs, ref_mesh, binary=fmt == "ply")
    else:
        getattr(timp, f"save_{fmt}")(ours, ref_mesh)
        getattr(jimp, f"save_{fmt}")(theirs, ref_mesh)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got = timp.load_model(ours)
    _same_mesh(got, jimp.load_model(ours))
    # the same triangles as the mesh written (STL flattens the sharing)
    want = tgeo.gather_triangles(ref_mesh, np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(
        tgeo.gather_triangles(got, np.eye(4, dtype=np.float32)), want,
        atol=1e-5)


def _glb_json(path):
    with open(path, "rb") as fh:
        blob = fh.read()
    (jlen,) = struct.unpack_from("<I", blob, 12)
    return blob, jlen, json.loads(blob[20:20 + jlen].decode("utf-8"))


def _hand_made(tmp_path, ref_mesh, kind):
    """A file of `kind` the assets do not cover; returns its path."""
    verts, faces = ref_mesh
    if kind == "gltf_data_uri":
        timp.save_glb(str(tmp_path / "m.glb"), ref_mesh)
        blob, jlen, gltf = _glb_json(str(tmp_path / "m.glb"))
        boff = 20 + jlen + 8
        binv = blob[boff:boff + gltf["buffers"][0]["byteLength"]]
        gltf["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                     + base64.b64encode(binv).decode())
        path = tmp_path / "m.gltf"
        path.write_text(json.dumps(gltf))
    elif kind == "glb_node_trs":
        timp.save_glb(str(tmp_path / "m.glb"), ref_mesh)
        blob, jlen, gltf = _glb_json(str(tmp_path / "m.glb"))
        gltf["nodes"][0].update(translation=[1.0, 2.0, 3.0],
                                scale=[2.0, 2.0, 2.0],
                                rotation=[0.0, 0.38268343, 0.0, 0.9238795])
        js = json.dumps(gltf).encode("utf-8")
        js += b" " * (-len(js) % 4)
        rest = blob[20 + jlen:]
        path = tmp_path / "m_t.glb"
        path.write_bytes(struct.pack("<4sII", b"glTF", 2,
                                     20 + len(js) + len(rest))
                         + struct.pack("<II", len(js), 0x4E4F534A) + js
                         + rest)
    elif kind in ("dae_zup_node", "dae_polylist"):
        timp.save_dae(str(tmp_path / "m.dae"), ref_mesh)
        doc = (tmp_path / "m.dae").read_text()
        if kind == "dae_zup_node":
            doc = doc.replace("<up_axis>Y_UP</up_axis>",
                              "<up_axis>Z_UP</up_axis>")
            doc = doc.replace('<node id="n0">',
                              '<node id="n0"><translate>1 2 3</translate>'
                              '<rotate>0 0 1 90</rotate><scale>2 2 2</scale>')
        else:
            n = len(faces)
            quads = " ".join(f"{a} {b} {c} {c}" for a, b, c in faces)
            doc = doc.replace(
                doc[doc.index("<triangles"):doc.index("</triangles>")
                    + len("</triangles>")],
                f'<polylist count="{n}"><input semantic="VERTEX" '
                f'source="#vtx" offset="0"/><vcount>{" ".join(["4"] * n)}'
                f'</vcount><p>{quads}</p></polylist>')
        path = tmp_path / f"{kind}.dae"
        path.write_text(doc)
    elif kind == "stl_ascii":
        path = tmp_path / "a.stl"
        with open(path, "w") as fh:
            fh.write("solid m\n")
            for t in verts[faces]:
                fh.write("facet normal 0 0 0\nouter loop\n")
                for v in t:
                    fh.write(f"vertex {v[0]} {v[1]} {v[2]}\n")
                fh.write("endloop\nendfacet\n")
            fh.write("endsolid m\n")
    elif kind == "fbx_ascii":
        path = tmp_path / "a.fbx"
        path.write_text("; FBX 7.4.0 project file\nObjects:  {\n"
                        '    Geometry: 1, "Geometry::", "Mesh" {\n'
                        "        Vertices: *15 {\n"
                        "            a: 0,0,0,1,0,0,1,1,0,0,1,0,0,0,2\n"
                        "        }\n        PolygonVertexIndex: *7 {\n"
                        "            a: 0,1,-3,0,2,4,-4\n        }\n"
                        "    }\n}\n")
    elif kind == "ply_list_vertex":
        path = tmp_path / "l.ply"
        head = ("ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property list uchar float extras\n"
                "element edge 2\nproperty int flag\n"
                "property list uchar int verts\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        with open(path, "wb") as fh:
            fh.write(head.encode("ascii"))
            for v in verts:
                fh.write(struct.pack("<3fB2f", *[float(x) for x in v], 2,
                                     0.5, 0.25))
            for k in range(2):
                fh.write(struct.pack(f"<iB{k + 1}i", k, k + 1,
                                     *range(k + 1)))
            for f in faces:
                fh.write(struct.pack("<B3i", 3, *[int(x) for x in f]))
    else:
        raise AssertionError(kind)
    return str(path)


@pytest.mark.parametrize("kind", ["gltf_data_uri", "glb_node_trs",
                                  "dae_zup_node", "dae_polylist",
                                  "stl_ascii", "fbx_ascii",
                                  "ply_list_vertex"])
def test_hand_made_files_equal_jax(tmp_path, ref_mesh, kind):
    path = _hand_made(tmp_path, ref_mesh, kind)
    got = timp.load_model(path)
    _same_mesh(got, jimp.load_model(path))
    assert len(got[1]) > 0


@pytest.mark.parametrize("name,blob", [
    ("bad.3ds", b"\x4d\x4d\x10\x00\x00\x00" + b"\0" * 4),
    ("bad.fbx", b"Kaydara FBX Binary  \x00\x1a\x00" + b"\0" * 8),
    ("loop.fbx", b"Kaydara FBX Binary  \x00\x1a\x00"
     + struct.pack("<I", 7400) + struct.pack("<IIIB", 27, 0, 0, 1) + b"X"
     + b"\0" * 13),
    ("junk.fbx", b"whatever"),
    ("m.xyz", b"1 2 3"),
    ("empty.ply", b"ply\nformat ascii 1.0\nend_header\n"),
])
def test_malformed_files_raise_like_jax(tmp_path, name, blob):
    path = tmp_path / name
    path.write_bytes(blob)
    for load in (timp.load_model, jimp.load_model):
        with pytest.raises(ValueError):
            load(str(path))


def test_procedural_meshes_equal_jax():
    _same_mesh(tgeo.make_plane(), jgeo.make_plane())
    _same_mesh(tgeo.make_plane(3.0, -1.0), jgeo.make_plane(3.0, -1.0))
    _same_mesh(tgeo.make_uv_sphere(), jgeo.make_uv_sphere())
    _same_mesh(tgeo.make_uv_sphere(0.5, 6, 9), jgeo.make_uv_sphere(0.5, 6, 9))


def test_gather_triangles_fast_validates_indices(ref_mesh):
    verts, faces = ref_mesh
    bad = faces.copy()
    bad[3, 1] = len(verts)
    for gather in (tgeo.gather_triangles_fast, jgeo.gather_triangles_fast):
        with pytest.raises(IndexError, match="out of range"):
            gather((verts, bad), XF)
    neg = faces.copy()
    neg[0, 0] = -1
    with pytest.raises(IndexError, match="out of range"):
        tgeo.gather_triangles_fast((verts, neg), XF)


def test_app_state_loads_every_model():
    """AppState.load_bvh_model takes every asset through load_model, the
    gather and the BVH builder onto the device; a file that fails keeps
    the previous tree and returns False."""
    st = AppState(height=8, width=8, device="cpu")
    assert sorted(os.path.relpath(p, REPO)
                  for p in st.model_picker.entries) == MODELS
    for rel in MODELS:
        path = os.path.join(REPO, rel)
        assert st.load_bvh_model(path), rel
        assert st.bvh_tri_count == len(jimp.load_model(path)[1])
        assert st.bvh.arrays.bounds.device.type == "cpu"
        assert st.bvh_node_count == st.bvh.arrays.bounds.shape[0]
    before = st.bvh
    assert not st.load_bvh_model(os.path.join(REPO, "models", "none.obj"))
    assert st.bvh is before
