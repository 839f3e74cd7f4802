// Native runtime components: BVH builder + OBJ loader.
//
// The port's own copy of the JAX package's C++ (rt_rs_tpu/native/
// rt_native.cpp): the reference implements these CPU-side pieces in Rust
// (src/lib/bvh/aabb.rs, and the `wavefront` crate used by
// src/tools/construct.rs); here they are C++ behind a C ABI consumed via
// ctypes (rt_rs_tpu_torch/native/bindings.py).  The NumPy builder
// (rt_rs_tpu_torch/bvh/builder.py) and the Python OBJ parser
// (rt_rs_tpu_torch/scene/obj.py) remain the oracles; the native builder
// must match them BIT-FOR-BIT (same f32 operations in the same order as
// aabb.rs:149-281; tests/test_torch_native.py), so it is compiled with
// -ffp-contract=off and without fast-math (native/build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <string>
#include <memory>

namespace {

struct V3 {
    float x, y, z;
};

static inline V3 vmin(V3 a, V3 b) {
    return {a.x < b.x ? a.x : b.x, a.y < b.y ? a.y : b.y,
            a.z < b.z ? a.z : b.z};
}
static inline V3 vmax(V3 a, V3 b) {
    return {a.x > b.x ? a.x : b.x, a.y > b.y ? a.y : b.y,
            a.z > b.z ? a.z : b.z};
}

// ---------------------------------------------------------------------
// BVH builder (aabb.rs:149-281 semantics, f32 exact)

struct Node {
    V3 bmin, bmax;
    std::vector<int64_t> items;  // leaf items (empty for interior)
    int32_t fst = -1, snd = -1;  // indices into the node pool
};

struct BvhBuild {
    std::vector<Node> pool;
    // flattened output
    std::vector<uint32_t> fst, snd, item_idx, item_count, indices;
    std::vector<float> bmin, bmax;
};

struct BuildCtx {
    const V3* pmin;   // per-prim vertex minima
    const V3* pmax;
    const V3* cent;   // per-prim centroids (f32, reference order)
    float eps_half;
    int64_t target;
    std::vector<Node>* pool;
};

// Iterative split matching Aabb::split (aabb.rs:149-248), including
// the in-place re-split loop for empty halves.
static void split_all(BuildCtx& ctx, int32_t root) {
    std::vector<int32_t> stack{root};
    while (!stack.empty()) {
        int32_t ni = stack.back();
        stack.pop_back();
        for (;;) {
            Node& node = (*ctx.pool)[ni];
            if ((int64_t)node.items.size() <= ctx.target) break;

            float dx = node.bmax.x - node.bmin.x;
            float dy = node.bmax.y - node.bmin.y;
            float dz = node.bmax.z - node.bmin.z;

            int axis;
            if (dx >= dy && dx >= dz) axis = 0;
            else if (dy >= dz && dy >= dx) axis = 1;
            else axis = 2;
            float d_axis = axis == 0 ? dx : (axis == 1 ? dy : dz);
            if (d_axis < ctx.eps_half) break;

            V3 fst_min = node.bmin, fst_max = node.bmax;
            V3 snd_min = node.bmin, snd_max = node.bmax;
            float mid;
            switch (axis) {
                case 0: mid = node.bmin.x + dx * 0.5f;
                        fst_max.x = mid; snd_min.x = mid; break;
                case 1: mid = node.bmin.y + dy * 0.5f;
                        fst_max.y = mid; snd_min.y = mid; break;
                default: mid = node.bmin.z + dz * 0.5f;
                         fst_max.z = mid; snd_min.z = mid; break;
            }

            std::vector<int64_t> fst_items, snd_items;
            fst_items.reserve(node.items.size());
            snd_items.reserve(node.items.size());
            for (int64_t it : node.items) {
                V3 c = ctx.cent[it];
                bool in_fst = c.x >= fst_min.x && c.x <= fst_max.x &&
                              c.y >= fst_min.y && c.y <= fst_max.y &&
                              c.z >= fst_min.z && c.z <= fst_max.z;
                (in_fst ? fst_items : snd_items).push_back(it);
            }

            if (fst_items.empty()) {
                node.bmin = snd_min;
                node.bmax = snd_max;
                continue;  // re-split in place (aabb.rs:221-224)
            }
            if (snd_items.empty()) {
                node.bmin = fst_min;
                node.bmax = fst_max;
                continue;  // aabb.rs:225-228
            }

            // Refit children to contents (Bounds::new, aabb.rs:232-241).
            auto extrema = [&](const std::vector<int64_t>& items, V3& lo,
                               V3& hi) {
                lo = {3.402823466e38f, 3.402823466e38f, 3.402823466e38f};
                hi = {-3.402823466e38f, -3.402823466e38f, -3.402823466e38f};
                for (int64_t it : items) {
                    lo = vmin(lo, ctx.pmin[it]);
                    hi = vmax(hi, ctx.pmax[it]);
                }
            };

            Node a, b;
            extrema(fst_items, a.bmin, a.bmax);
            extrema(snd_items, b.bmin, b.bmax);
            a.items = std::move(fst_items);
            b.items = std::move(snd_items);

            int32_t ai = (int32_t)ctx.pool->size();
            ctx.pool->push_back(std::move(a));
            int32_t bi = (int32_t)ctx.pool->size();
            ctx.pool->push_back(std::move(b));
            // `node` may have been invalidated by the push_backs.
            Node& node2 = (*ctx.pool)[ni];
            node2.fst = ai;
            node2.snd = bi;
            node2.items.clear();
            stack.push_back(ai);
            stack.push_back(bi);
            break;
        }
    }
}

// Preorder flatten (BvhData::new, bvh/mod.rs:29-64).
static void flatten(BvhBuild& b, int32_t root) {
    struct Slot {
        int32_t node;
        int32_t parent;  // flattened index to patch (-1 = root)
        bool is_fst;
    };
    std::vector<Slot> stack{{root, -1, false}};
    while (!stack.empty()) {
        Slot s = stack.back();
        stack.pop_back();
        const Node& n = b.pool[s.node];
        uint32_t uniform = (uint32_t)b.fst.size();
        b.fst.push_back(0);
        b.snd.push_back(0);
        b.item_idx.push_back((uint32_t)b.indices.size());
        b.item_count.push_back((uint32_t)n.items.size());
        b.bmin.insert(b.bmin.end(), {n.bmin.x, n.bmin.y, n.bmin.z});
        b.bmax.insert(b.bmax.end(), {n.bmax.x, n.bmax.y, n.bmax.z});
        for (int64_t it : n.items) b.indices.push_back((uint32_t)it);
        if (s.parent >= 0) {
            (s.is_fst ? b.fst : b.snd)[s.parent] = uniform;
        }
        if (n.snd >= 0) stack.push_back({n.snd, (int32_t)uniform, false});
        if (n.fst >= 0) stack.push_back({n.fst, (int32_t)uniform, true});
    }
}

// ---------------------------------------------------------------------
// OBJ loader

struct ObjData {
    std::vector<double> positions;  // V*3
    std::vector<double> normals;    // N*3
    std::vector<int64_t> tri_pos;   // T*3
    std::vector<int64_t> tri_norm;  // T*3 (-1 = none)
};

static int64_t parse_index(const char* tok, int64_t count) {
    long long i = atoll(tok);
    return i > 0 ? i - 1 : count + i;
}

}  // namespace

extern "C" {

void* rt_bvh_build(const float* verts, const uint32_t* prim_idx,
                   int64_t num_verts, int64_t num_prims, float eps,
                   int64_t target_item_count, int64_t* out_num_nodes,
                   int64_t* out_num_indices) {
    (void)num_verts;
    auto* b = new BvhBuild();

    std::vector<V3> pmin(num_prims), pmax(num_prims), cent(num_prims);
    const V3* vs = reinterpret_cast<const V3*>(verts);
    for (int64_t p = 0; p < num_prims; ++p) {
        V3 a = vs[prim_idx[p * 3 + 0]];
        V3 bb = vs[prim_idx[p * 3 + 1]];
        V3 c = vs[prim_idx[p * 3 + 2]];
        pmin[p] = vmin(vmin(a, bb), c);
        pmax[p] = vmax(vmax(a, bb), c);
        // Centroid: ((a+b)*0.5 + (b+c)*0.5) + (c+a)*0.5, then * (1/3)
        // — f32 reference order (aabb.rs:196-209 / builder.py).
        const float third = 1.0f / 3.0f;
        V3 ab{(a.x + bb.x) * 0.5f, (a.y + bb.y) * 0.5f, (a.z + bb.z) * 0.5f};
        V3 bc{(bb.x + c.x) * 0.5f, (bb.y + c.y) * 0.5f, (bb.z + c.z) * 0.5f};
        V3 ca{(c.x + a.x) * 0.5f, (c.y + a.y) * 0.5f, (c.z + a.z) * 0.5f};
        cent[p] = {((ab.x + bc.x) + ca.x) * third,
                   ((ab.y + bc.y) + ca.y) * third,
                   ((ab.z + bc.z) + ca.z) * third};
    }

    Node root;
    root.bmin = {3.402823466e38f, 3.402823466e38f, 3.402823466e38f};
    root.bmax = {-3.402823466e38f, -3.402823466e38f, -3.402823466e38f};
    root.items.resize(num_prims);
    for (int64_t p = 0; p < num_prims; ++p) {
        root.items[p] = p;
        root.bmin = vmin(root.bmin, pmin[p]);
        root.bmax = vmax(root.bmax, pmax[p]);
    }
    if (num_prims == 0) {
        root.items = {0};  // from_scene_unloaded (aabb.rs:250-257)
    }
    b->pool.push_back(std::move(root));

    BuildCtx ctx{pmin.data(), pmax.data(), cent.data(),
                 eps * 0.5f, target_item_count, &b->pool};
    if (num_prims > 0) split_all(ctx, 0);
    flatten(*b, 0);

    *out_num_nodes = (int64_t)b->fst.size();
    *out_num_indices = (int64_t)b->indices.size();
    return b;
}

void rt_bvh_read(void* handle, uint32_t* fst, uint32_t* snd,
                 uint32_t* item_idx, uint32_t* item_count, float* bmin,
                 float* bmax, uint32_t* indices) {
    auto* b = static_cast<BvhBuild*>(handle);
    memcpy(fst, b->fst.data(), b->fst.size() * 4);
    memcpy(snd, b->snd.data(), b->snd.size() * 4);
    memcpy(item_idx, b->item_idx.data(), b->item_idx.size() * 4);
    memcpy(item_count, b->item_count.data(), b->item_count.size() * 4);
    memcpy(bmin, b->bmin.data(), b->bmin.size() * 4);
    memcpy(bmax, b->bmax.data(), b->bmax.size() * 4);
    memcpy(indices, b->indices.data(), b->indices.size() * 4);
}

void rt_bvh_free(void* handle) { delete static_cast<BvhBuild*>(handle); }

void* rt_obj_load(const char* path, int64_t* n_pos, int64_t* n_norm,
                  int64_t* n_tris) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* o = new ObjData();

    char line[4096];
    std::vector<std::pair<int64_t, int64_t>> face;  // (pos, norm)
    while (fgets(line, sizeof line, f)) {
        char* s = line;
        while (*s == ' ' || *s == '\t') ++s;
        if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
            double x, y, z;
            if (sscanf(s + 1, "%lf %lf %lf", &x, &y, &z) == 3) {
                o->positions.insert(o->positions.end(), {x, y, z});
            }
        } else if (s[0] == 'v' && s[1] == 'n') {
            double x, y, z;
            if (sscanf(s + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
                o->normals.insert(o->normals.end(), {x, y, z});
            }
        } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
            face.clear();
            char* save = nullptr;
            for (char* tok = strtok_r(s + 1, " \t\r\n", &save); tok;
                 tok = strtok_r(nullptr, " \t\r\n", &save)) {
                // forms: v, v/t, v//n, v/t/n
                int64_t vi = parse_index(tok, (int64_t)o->positions.size() / 3);
                int64_t ni = -1;
                char* slash1 = strchr(tok, '/');
                if (slash1) {
                    char* slash2 = strchr(slash1 + 1, '/');
                    if (slash2 && slash2[1] != '\0') {
                        ni = parse_index(slash2 + 1,
                                         (int64_t)o->normals.size() / 3);
                    }
                }
                face.push_back({vi, ni});
            }
            for (size_t k = 1; k + 1 < face.size(); ++k) {  // fan
                o->tri_pos.insert(o->tri_pos.end(),
                                  {face[0].first, face[k].first,
                                   face[k + 1].first});
                o->tri_norm.insert(o->tri_norm.end(),
                                   {face[0].second, face[k].second,
                                    face[k + 1].second});
            }
        }
    }
    fclose(f);
    *n_pos = (int64_t)o->positions.size() / 3;
    *n_norm = (int64_t)o->normals.size() / 3;
    *n_tris = (int64_t)o->tri_pos.size() / 3;
    return o;
}

void rt_obj_read(void* handle, double* pos, double* norm, int64_t* tri_pos,
                 int64_t* tri_norm) {
    auto* o = static_cast<ObjData*>(handle);
    memcpy(pos, o->positions.data(), o->positions.size() * 8);
    if (!o->normals.empty())
        memcpy(norm, o->normals.data(), o->normals.size() * 8);
    memcpy(tri_pos, o->tri_pos.data(), o->tri_pos.size() * 8);
    memcpy(tri_norm, o->tri_norm.data(), o->tri_norm.size() * 8);
}

void rt_obj_free(void* handle) { delete static_cast<ObjData*>(handle); }

}  // extern "C"
