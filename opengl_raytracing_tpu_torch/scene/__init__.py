"""Scene data on the host: procedural geometry, model import, triangle
gather, BVH build."""

from .bvh import (BVH, BVHArrays, LEAF_MAX, build_bvh, build_bvh_fast,
                  bvh_to_arrays, validate_bvh)
from .geometry import (make_plane, make_uv_sphere, make_icosphere,
                       make_bunny, model_transform, gather_triangles,
                       gather_triangles_fast, load_obj, load_obj_fast,
                       save_obj)
from .importers import MODEL_EXTENSIONS, load_model
