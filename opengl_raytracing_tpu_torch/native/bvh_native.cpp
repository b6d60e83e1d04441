// Native runtime components for opengl_raytracing_tpu_torch.
//
// A copy of opengl_raytracing_tpu/native/bvh_native.cpp with the same C
// ABI and the same code, so that on one machine it builds the very tree
// the JAX package's library builds (the same algorithm and the same
// std::nth_element calls, whose tie order the numpy builder does not
// share).  C++ counterparts of the reference's host code:
//   * median-split BVH builder with leaf remap
//     (algorithm parity with reference: src/scene/bvh.cpp:41-137, emitting
//     the preorder skip-link layout of scene/bvh.py)
//   * OBJ mesh parser (replaces the assimp import path,
//     reference: include/scene/model.h:49-229)
//   * 4x3-cross cubemap slicer (reference: src/render/cubemap.cpp:35-106)
//
// Exposed as a plain C ABI for ctypes (native/__init__.py); the numpy
// and Python forms in scene/ and utils/ stand in for it only where no
// g++ is on PATH.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct BuildRef {
    int tri;
    V3 c;
};

struct BvhResult {
    std::vector<float> bmin, bmax;            // [N,3]
    std::vector<int32_t> left, right, first, count, skip;  // [N]
    std::vector<float> tris;                  // [T,9] remapped
};

struct Frame {
    int begin, end, parent_slot;  // slot >= 0: left child of slot;
                                  // slot < 0: right child of (-slot-1)
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// BVH builder
// ---------------------------------------------------------------------------

void *bvh_build(const float *tris, int n_tris, int leaf_max) {
    auto *res = new BvhResult();
    if (n_tris <= 0) return res;

    std::vector<V3> tmin(n_tris), tmax(n_tris);
    std::vector<BuildRef> order(n_tris);
    for (int i = 0; i < n_tris; ++i) {
        const float *t = tris + static_cast<size_t>(i) * 9;
        V3 v0{t[0], t[1], t[2]};
        V3 v1{t[0] + t[3], t[1] + t[4], t[2] + t[5]};
        V3 v2{t[0] + t[6], t[1] + t[7], t[2] + t[8]};
        tmin[i] = vmin(v0, vmin(v1, v2));
        tmax[i] = vmax(v0, vmax(v1, v2));
        order[i] = {i, {(v0.x + v1.x + v2.x) / 3.0f,
                        (v0.y + v1.y + v2.y) / 3.0f,
                        (v0.z + v1.z + v2.z) / 3.0f}};
    }

    res->tris.reserve(static_cast<size_t>(n_tris) * 9);
    int remap_cursor = 0;

    // Iterative preorder build, left child processed immediately after the
    // parent (preorder guarantee: left == parent + 1).
    std::vector<Frame> stack;
    stack.push_back({0, n_tris, INT32_MIN});
    while (!stack.empty()) {
        Frame f = stack.back();
        stack.pop_back();
        V3 node_min{1e30f, 1e30f, 1e30f}, node_max{-1e30f, -1e30f, -1e30f};
        for (int i = f.begin; i < f.end; ++i) {
            node_min = vmin(node_min, tmin[order[i].tri]);
            node_max = vmax(node_max, tmax[order[i].tri]);
        }
        const int me = static_cast<int>(res->left.size());
        res->bmin.insert(res->bmin.end(), {node_min.x, node_min.y, node_min.z});
        res->bmax.insert(res->bmax.end(), {node_max.x, node_max.y, node_max.z});
        res->left.push_back(-1);
        res->right.push_back(-1);
        res->first.push_back(-1);
        res->count.push_back(0);
        res->skip.push_back(-1);
        if (f.parent_slot != INT32_MIN) {
            if (f.parent_slot >= 0)
                res->left[f.parent_slot] = me;
            else
                res->right[-f.parent_slot - 1] = me;
        }

        const int count = f.end - f.begin;
        if (count <= leaf_max) {
            for (int i = f.begin; i < f.end; ++i) {
                const float *t = tris + static_cast<size_t>(order[i].tri) * 9;
                res->tris.insert(res->tris.end(), t, t + 9);
            }
            res->first[me] = remap_cursor;
            res->count[me] = count;
            remap_cursor += count;
            continue;
        }

        // Split axis: largest extent, x wins only if strictly larger
        // (same tie-break as reference: src/scene/bvh.cpp:72).
        const float ex = node_max.x - node_min.x;
        const float ey = node_max.y - node_min.y;
        const float ez = node_max.z - node_min.z;
        int axis;
        if (ex > ey)
            axis = (ex > ez) ? 0 : 2;
        else
            axis = (ey > ez) ? 1 : 2;

        const int mid = f.begin + count / 2;
        std::nth_element(order.begin() + f.begin, order.begin() + mid,
                         order.begin() + f.end,
                         [axis](const BuildRef &a, const BuildRef &b) {
                             const float *pa = &a.c.x, *pb = &b.c.x;
                             return pa[axis] < pb[axis];
                         });
        // Push right first so left pops next (preorder left-first).
        stack.push_back({mid, f.end, -me - 1});
        stack.push_back({f.begin, mid, me});
    }

    // Skip links: skip[root] = N; skip[left]=right, skip[right]=skip[parent].
    const int n_nodes = static_cast<int>(res->left.size());
    for (int i = 0; i < n_nodes; ++i) res->skip[i] = n_nodes;
    for (int i = 0; i < n_nodes; ++i) {
        if (res->count[i] == 0 && res->left[i] >= 0) {
            res->skip[res->left[i]] = res->right[i];
            res->skip[res->right[i]] = res->skip[i];
        }
    }
    return res;
}

int bvh_num_nodes(void *h) {
    return static_cast<int>(static_cast<BvhResult *>(h)->left.size());
}

int bvh_num_tris(void *h) {
    return static_cast<int>(static_cast<BvhResult *>(h)->tris.size() / 9);
}

void bvh_copy(void *h, float *bmin, float *bmax, int32_t *left,
              int32_t *right, int32_t *first, int32_t *count, int32_t *skip,
              float *tris_out) {
    auto *r = static_cast<BvhResult *>(h);
    std::memcpy(bmin, r->bmin.data(), r->bmin.size() * sizeof(float));
    std::memcpy(bmax, r->bmax.data(), r->bmax.size() * sizeof(float));
    std::memcpy(left, r->left.data(), r->left.size() * sizeof(int32_t));
    std::memcpy(right, r->right.data(), r->right.size() * sizeof(int32_t));
    std::memcpy(first, r->first.data(), r->first.size() * sizeof(int32_t));
    std::memcpy(count, r->count.data(), r->count.size() * sizeof(int32_t));
    std::memcpy(skip, r->skip.data(), r->skip.size() * sizeof(int32_t));
    std::memcpy(tris_out, r->tris.data(), r->tris.size() * sizeof(float));
}

void bvh_free(void *h) { delete static_cast<BvhResult *>(h); }

// ---------------------------------------------------------------------------
// OBJ parser (positions + triangulated faces; fan triangulation like the
// reference's assimp aiProcess_Triangulate path)
// ---------------------------------------------------------------------------

struct ObjResult {
    std::vector<float> verts;    // [V,3]
    std::vector<int32_t> faces;  // [F,3]
};

void *obj_load(const char *path) {
    std::ifstream in(path);
    if (!in.good()) return nullptr;
    auto *res = new ObjResult();
    std::string line;
    std::vector<int> idx;
    while (std::getline(in, line)) {
        if (line.size() < 2) continue;
        if (line[0] == 'v' && line[1] == ' ') {
            float x, y, z;
            if (std::sscanf(line.c_str() + 2, "%f %f %f", &x, &y, &z) == 3) {
                res->verts.insert(res->verts.end(), {x, y, z});
            } else {
                // Malformed vertex: fail the whole parse.  Silently
                // dropping the line would shift every later face index
                // into the wrong vertex; returning null routes the caller
                // to the Python parser, which raises like the oracle.
                delete res;
                return nullptr;
            }
        } else if (line[0] == 'f' && line[1] == ' ') {
            idx.clear();
            std::istringstream ss(line.substr(2));
            std::string tok;
            const int nv = static_cast<int>(res->verts.size() / 3);
            while (ss >> tok) {
                int v = std::atoi(tok.c_str());  // stops at '/'
                idx.push_back(v > 0 ? v - 1 : nv + v);
            }
            for (size_t j = 1; j + 1 < idx.size(); ++j) {
                res->faces.insert(res->faces.end(),
                                  {idx[0], static_cast<int32_t>(idx[j]),
                                   static_cast<int32_t>(idx[j + 1])});
            }
        }
    }
    return res;
}

int obj_num_verts(void *h) {
    return h ? static_cast<int>(static_cast<ObjResult *>(h)->verts.size() / 3)
             : 0;
}

int obj_num_faces(void *h) {
    return h ? static_cast<int>(static_cast<ObjResult *>(h)->faces.size() / 3)
             : 0;
}

void obj_copy(void *h, float *verts, int32_t *faces) {
    auto *r = static_cast<ObjResult *>(h);
    std::memcpy(verts, r->verts.data(), r->verts.size() * sizeof(float));
    std::memcpy(faces, r->faces.data(), r->faces.size() * sizeof(int32_t));
}

void obj_free(void *h) { delete static_cast<ObjResult *>(h); }

// ---------------------------------------------------------------------------
// Triangle gather: indexed mesh + 4x4 transform -> (v0,e1,e2) rows
// (reference: src/scene/bvh.cpp:225-246)
// ---------------------------------------------------------------------------

void gather_triangles(const float *verts, int n_verts, const int32_t *faces,
                      int n_faces, const float *m4x4, float *out9) {
    (void)n_verts;
    const float *m = m4x4;
    auto xf = [m](const float *p, float *o) {
        for (int r = 0; r < 3; ++r)
            o[r] = m[r * 4 + 0] * p[0] + m[r * 4 + 1] * p[1]
                 + m[r * 4 + 2] * p[2] + m[r * 4 + 3];
    };
    for (int f = 0; f < n_faces; ++f) {
        float p0[3], p1[3], p2[3];
        xf(verts + faces[f * 3 + 0] * 3, p0);
        xf(verts + faces[f * 3 + 1] * 3, p1);
        xf(verts + faces[f * 3 + 2] * 3, p2);
        float *o = out9 + static_cast<size_t>(f) * 9;
        for (int k = 0; k < 3; ++k) {
            o[k] = p0[k];
            o[3 + k] = p1[k] - p0[k];
            o[6 + k] = p2[k] - p0[k];
        }
    }
}

// ---------------------------------------------------------------------------
// Cubemap cross slicer: 4x3 cross image -> 6 faces (+X,-X,+Y,-Y,+Z,-Z)
// layout per reference: src/render/cubemap.cpp:86-91
// ---------------------------------------------------------------------------

int cubemap_slice(const uint8_t *img, int h, int w, int ch, float *out) {
    if (h % 3 != 0 || w % 4 != 0 || (w / 4) != (h / 3)) return -1;
    const int f = h / 3;
    static const int layout[6][2] = {{2, 1}, {0, 1}, {1, 0},
                                     {1, 2}, {1, 1}, {3, 1}};
    for (int face = 0; face < 6; ++face) {
        const int ox = layout[face][0] * f, oy = layout[face][1] * f;
        for (int y = 0; y < f; ++y) {
            const uint8_t *src = img + (static_cast<size_t>(oy + y) * w + ox)
                                 * ch;
            float *dst = out + ((static_cast<size_t>(face) * f + y) * f) * 3;
            for (int x = 0; x < f; ++x) {
                dst[x * 3 + 0] = src[x * ch + 0] / 255.0f;
                dst[x * 3 + 1] = src[x * ch + 1] / 255.0f;
                dst[x * 3 + 2] = src[x * ch + 2] / 255.0f;
            }
        }
    }
    return f;
}

}  // extern "C"
