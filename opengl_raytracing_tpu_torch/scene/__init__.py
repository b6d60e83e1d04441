"""Scene data on the host: procedural geometry, model import, triangle
gather, BVH build."""

from .bvh import BVH, BVHArrays, LEAF_MAX, build_bvh, bvh_to_arrays
from .geometry import (make_plane, make_uv_sphere, make_icosphere,
                       make_bunny, model_transform, gather_triangles,
                       gather_triangles_fast, load_obj, save_obj)
from .importers import MODEL_EXTENSIONS, load_model
