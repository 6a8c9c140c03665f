// psdr_tpu native runtime: host-side builders and loaders.
//
// Host-side equivalents of the reference's native components:
//  * obj_*       — OBJ mesh parsing (replaces vendored tinyobjloader,
//                  the reference's mesh.cpp:62-141 is the behavioral spec)
//  * build_edges — 2-manifold edge-adjacency table (mesh.cpp:143-203)
//  * morton_topology — acceleration-structure build: Morton sort + complete
//                  implicit tree topology (the OptiX GAS-build analog,
//                  scene_optix.cpp:34-72); the AABB refit runs on-device in JAX.
//
// Exposed as a C ABI consumed through ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC psdr_native.cpp -o libpsdr_native.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct ObjMesh {
    std::vector<float> verts;    // 3 * nv
    std::vector<float> uvs;      // 2 * nt
    std::vector<float> normals;  // 3 * nn (vn channel)
    std::vector<int32_t> faces;  // 3 * nf (vertex ids)
    std::vector<int32_t> fuvs;   // 3 * nf (uv ids, -1 if none)
    std::vector<int32_t> fnrm;   // 3 * nf (normal ids, -1 if none)
    bool has_uv_faces = false;
    bool has_nrm_faces = false;
};

// fast float parse over a whitespace-separated span
inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

}  // namespace

extern "C" {

void* obj_load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (fread(buf.data(), 1, size, f) != (size_t)size) { fclose(f); return nullptr; }
    fclose(f);
    buf[size] = '\n';

    auto* m = new ObjMesh();
    const char* p = buf.data();
    const char* end = buf.data() + size;
    std::vector<int> vidx, tidx, nidx;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q + 1 < line_end && q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
            char* r = const_cast<char*>(q + 1);
            for (int k = 0; k < 3; ++k) m->verts.push_back(strtof(r, &r));
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't'
                   && (q[2] == ' ' || q[2] == '\t')) {
            char* r = const_cast<char*>(q + 2);
            for (int k = 0; k < 2; ++k) m->uvs.push_back(strtof(r, &r));
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n'
                   && (q[2] == ' ' || q[2] == '\t')) {
            char* r = const_cast<char*>(q + 2);
            for (int k = 0; k < 3; ++k) m->normals.push_back(strtof(r, &r));
        } else if (q + 1 < line_end && q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
            vidx.clear(); tidx.clear(); nidx.clear();
            const char* r = q + 1;
            while (r < line_end) {
                r = skip_ws(r, line_end);
                if (r >= line_end || *r == '\n') break;
                char* e;
                long v = strtol(r, &e, 10);
                if (e == r) break;
                long t = 0, nn = 0;
                bool has_t = false, has_n = false;
                r = e;
                if (r < line_end && *r == '/') {
                    ++r;
                    if (r < line_end && *r != '/') {
                        t = strtol(r, &e, 10);
                        has_t = true;
                        r = e;
                    }
                    if (r < line_end && *r == '/') {  // normal index
                        ++r;
                        nn = strtol(r, &e, 10);
                        has_n = e != r;
                        r = e;
                    }
                }
                vidx.push_back((int)(v > 0 ? v - 1 : (long)(m->verts.size() / 3) + v));
                tidx.push_back(has_t ? (int)(t > 0 ? t - 1 : (long)(m->uvs.size() / 2) + t) : -1);
                nidx.push_back(has_n ? (int)(nn > 0 ? nn - 1 : (long)(m->normals.size() / 3) + nn) : -1);
                if (has_t) m->has_uv_faces = true;
                if (has_n) m->has_nrm_faces = true;
            }
            for (size_t k = 1; k + 1 < vidx.size(); ++k) {  // fan triangulation
                m->faces.push_back(vidx[0]);
                m->faces.push_back(vidx[k]);
                m->faces.push_back(vidx[k + 1]);
                m->fuvs.push_back(tidx[0] < 0 ? 0 : tidx[0]);
                m->fuvs.push_back(tidx[k] < 0 ? 0 : tidx[k]);
                m->fuvs.push_back(tidx[k + 1] < 0 ? 0 : tidx[k + 1]);
                m->fnrm.push_back(nidx[0]);      // -1 = no vn on corner
                m->fnrm.push_back(nidx[k]);
                m->fnrm.push_back(nidx[k + 1]);
            }
        }
        p = line_end + 1;
    }
    return m;
}

void obj_counts(void* handle, int32_t* nv, int32_t* nf, int32_t* nt,
                int32_t* nn, int32_t* has_uv, int32_t* has_nrm) {
    auto* m = (ObjMesh*)handle;
    *nv = (int32_t)(m->verts.size() / 3);
    *nf = (int32_t)(m->faces.size() / 3);
    *nt = (int32_t)(m->uvs.size() / 2);
    *nn = (int32_t)(m->normals.size() / 3);
    *has_uv = m->has_uv_faces ? 1 : 0;
    *has_nrm = m->has_nrm_faces ? 1 : 0;
}

void obj_copy(void* handle, float* verts, int32_t* faces, float* uvs,
              int32_t* fuvs, float* normals, int32_t* fnrm) {
    auto* m = (ObjMesh*)handle;
    memcpy(verts, m->verts.data(), m->verts.size() * sizeof(float));
    memcpy(faces, m->faces.data(), m->faces.size() * sizeof(int32_t));
    if (!m->uvs.empty()) memcpy(uvs, m->uvs.data(), m->uvs.size() * sizeof(float));
    if (!m->fuvs.empty()) memcpy(fuvs, m->fuvs.data(), m->fuvs.size() * sizeof(int32_t));
    if (!m->normals.empty()) memcpy(normals, m->normals.data(), m->normals.size() * sizeof(float));
    if (!m->fnrm.empty()) memcpy(fnrm, m->fnrm.data(), m->fnrm.size() * sizeof(int32_t));
}

void obj_free(void* handle) { delete (ObjMesh*)handle; }

// Edge-adjacency table. out rows: [v0, v1, face0, face1|-1, opp_vertex0].
// Returns edge count, -1 on >2-manifold, -2 on duplicated face pair.
int32_t build_edges(const int32_t* faces, int32_t nf, int32_t* out,
                    int32_t max_edges) {
    std::unordered_map<uint64_t, int32_t> first;  // edge key -> out row
    first.reserve((size_t)nf * 3);
    int32_t ne = 0;
    for (int32_t f = 0; f < nf; ++f) {
        for (int k = 0; k < 3; ++k) {
            int32_t a = faces[3 * f + k];
            int32_t b = faces[3 * f + (k + 1) % 3];
            int32_t opp = faces[3 * f + (k + 2) % 3];
            uint64_t lo = (uint64_t)std::min(a, b);
            uint64_t hi = (uint64_t)std::max(a, b);
            uint64_t key = (lo << 32) | hi;
            auto it = first.find(key);
            if (it == first.end()) {
                if (ne >= max_edges) return -3;
                out[5 * ne + 0] = (int32_t)lo;
                out[5 * ne + 1] = (int32_t)hi;
                out[5 * ne + 2] = f;
                out[5 * ne + 3] = -1;
                out[5 * ne + 4] = opp;
                first.emplace(key, ne);
                ++ne;
            } else {
                int32_t row = it->second;
                if (out[5 * row + 3] >= 0) return -1;   // 3rd face on edge
                if (out[5 * row + 2] == f) return -2;   // duplicate face
                out[5 * row + 3] = f;
            }
        }
    }
    return ne;
}

// Morton-ordered complete-tree topology (the accel "build").
// perm_out must hold num_leaves*leaf_size entries (call morton_counts first),
// skip_out 2*num_leaves.
static inline uint64_t expand_bits(uint64_t v) {
    v = (v | (v << 16)) & 0x030000FFull;
    v = (v | (v << 8)) & 0x0300F00Full;
    v = (v | (v << 4)) & 0x030C30C3ull;
    v = (v | (v << 2)) & 0x09249249ull;
    return v;
}

int32_t morton_num_leaves(int32_t nf, int32_t leaf_size) {
    int32_t n_leaf = (nf + leaf_size - 1) / leaf_size;
    int32_t p = 1;
    while (p < n_leaf) p <<= 1;
    return p;
}

void morton_topology(const float* p0, const float* e1, const float* e2,
                     int32_t nf, int32_t leaf_size, int32_t* perm_out,
                     int32_t* skip_out) {
    std::vector<float> cx(nf), cy(nf), cz(nf);
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = 0; i < nf; ++i) {
        float c[3];
        for (int k = 0; k < 3; ++k) {
            c[k] = p0[3 * i + k] + (e1[3 * i + k] + e2[3 * i + k]) / 3.0f;
            mn[k] = std::min(mn[k], c[k]);
            mx[k] = std::max(mx[k], c[k]);
        }
        cx[i] = c[0]; cy[i] = c[1]; cz[i] = c[2];
    }
    float ext[3];
    for (int k = 0; k < 3; ++k)
        ext[k] = std::max(mx[k] - mn[k], 1e-12f);

    std::vector<std::pair<uint64_t, int32_t>> keys(nf);
    for (int32_t i = 0; i < nf; ++i) {
        auto q = [&](float v, int k) {
            float t = (v - mn[k]) / ext[k] * 1023.0f;
            return (uint64_t)std::min(std::max(t, 0.0f), 1023.0f);
        };
        uint64_t code = (expand_bits(q(cx[i], 0)) << 2)
                      | (expand_bits(q(cy[i], 1)) << 1)
                      | expand_bits(q(cz[i], 2));
        keys[i] = {code, i};
    }
    std::stable_sort(keys.begin(), keys.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });

    int32_t P = morton_num_leaves(nf, leaf_size);
    int32_t total = P * leaf_size;
    for (int32_t i = 0; i < total; ++i)
        perm_out[i] = i < nf ? keys[i].second : -1;

    int32_t n = 2 * P;
    skip_out[0] = 0;
    for (int32_t i = 1; i < n; ++i) {
        int32_t k = i;
        while ((k & 1) && k > 1) k >>= 1;
        skip_out[i] = k <= 1 ? 0 : k + 1;
    }
}

}  // extern "C"
