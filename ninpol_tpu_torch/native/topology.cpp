// Native mesh-topology engine.
//
// Built with -ffp-contract=off: the geometry kernels must be
// bit-identical to the NumPy reference path, and FMA contraction of
// the float32 cross products changes the rounding.
//
// C++ rebuild of the reference's Cython/C++ grid builder
// (ninpol/_interpolator/grid.pyx:142-580, compiled with -O3 there), used
// as the fast path for the one-time host-side topology construction; the
// NumPy implementation in _grid/topology.py is the portable fallback and
// correctness oracle.  Output orderings are identical:
//   - esup/psup/fsup/esuf CSR fill orders match the reference loops,
//   - faces/edges are numbered by first encounter in (element, local-slot)
//     order; the reference's robin_hood hash dedup becomes a
//     std::unordered_map with exact 4-point keys (no hash-collision risk).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>
#ifdef __linux__
#include <sys/mman.h>
#endif

using i64 = int64_t;
// Array ELEMENT type: int32 (all entity counts < 2^31).  Halves the
// memory this engine touches — in this microVM first-touch page faults
// dominate cold builds, so bytes ARE time.  Scalar sizes stay i64 in
// the C ABI.
using idx = int32_t;

namespace {

struct FaceKey {
    // sorted point ids packed two per i64 ((p+1) in 32-bit halves, exact
    // for p < 2^31): 16-byte keys keep the open-addressing table cache
    // friendly (the 4xi64 version thrashed at 1M-cell scale).
    uint64_t k1, k2;
    bool operator==(const FaceKey& o) const {
        return k1 == o.k1 && k2 == o.k2;
    }
};

inline FaceKey make_face_key(const idx* srt) {
    return FaceKey{
        ((uint64_t)(srt[0] + 1) << 32) | (uint64_t)(uint32_t)(srt[1] + 1),
        ((uint64_t)(srt[2] + 1) << 32) | (uint64_t)(uint32_t)(srt[3] + 1)};
}

struct FaceKeyHash {
    size_t operator()(const FaceKey& k) const {
        uint64_t h = 0x9e3779b97f4a7c15ull;
        for (uint64_t v : {k.k1, k.k2}) {
            v *= 0xbf58476d1ce4e5b9ull;
            v ^= v >> 27;
            h = (h ^ v) * 0x94d049bb133111ebull;
        }
        return (size_t)h;
    }
};

inline void sort4(idx* p) {
    // sorting network for 4 elements
    auto cswap = [](idx& x, idx& y) { if (x > y) std::swap(x, y); };
    cswap(p[0], p[1]); cswap(p[2], p[3]);
    cswap(p[0], p[2]); cswap(p[1], p[3]);
    cswap(p[1], p[2]);
}

}  // namespace

extern "C" {

// Elements surrounding each point (reference grid.pyx:233-267).
// conn: (n_elems, stride) padded with -1; npoel per element type.
void build_esup(i64 n_elems, i64 n_points, i64 stride,
                const idx* conn, const idx* etypes, const idx* npoel,
                idx* esup_ptr /*n_points+1*/, idx* esup /*total*/) {
    std::memset(esup_ptr, 0, sizeof(idx) * (n_points + 1));
    for (i64 e = 0; e < n_elems; ++e) {
        const i64 np = npoel[etypes[e]];
        const idx* row = conn + e * stride;
        for (i64 j = 0; j < np; ++j) esup_ptr[row[j] + 1]++;
    }
    for (i64 p = 0; p < n_points; ++p) esup_ptr[p + 1] += esup_ptr[p];
    for (i64 e = 0; e < n_elems; ++e) {
        const i64 np = npoel[etypes[e]];
        const idx* row = conn + e * stride;
        for (i64 j = 0; j < np; ++j) esup[esup_ptr[row[j]]++] = (idx)e;
    }
    for (i64 p = n_points; p > 0; --p) esup_ptr[p] = esup_ptr[p - 1];
    esup_ptr[0] = 0;
}

// Points surrounding each point, first-occurrence dedup
// (reference grid.pyx:269-302).  psup must be sized for the upper bound
// (esup total * (max points per element - 1)); returns actual length.
i64 build_psup(i64 n_elems, i64 n_points, i64 stride,
               const idx* conn, const idx* etypes, const idx* npoel,
               const idx* esup_ptr, const idx* esup,
               idx* psup_ptr /*n_points+1*/, idx* psup) {
    std::vector<idx> last_seen(n_points, -1);
    i64 stor = 0;
    psup_ptr[0] = 0;
    for (i64 p = 0; p < n_points; ++p) {
        for (i64 k = esup_ptr[p]; k < esup_ptr[p + 1]; ++k) {
            const i64 e = esup[k];
            const i64 np = npoel[etypes[e]];
            const idx* row = conn + e * stride;
            for (i64 j = 0; j < np; ++j) {
                const idx q = row[j];
                if (q != p && last_seen[q] != p) {
                    psup[stor++] = q;
                    last_seen[q] = (idx)p;
                }
            }
        }
        psup_ptr[p + 1] = (idx)stor;
    }
    return stor;
}

// Unique-face enumeration + element adjacency + boundary flags
// (reference grid.pyx:304-345, 381-446, 449-525).
// lpofa: (T, F, 4), lnofa: (T, F), nfael: (T).  Outputs:
//   infael (n_elems, 6), inpofa (cap_faces, 4), esuel (n_elems, 6),
//   boundary_faces (cap_faces), boundary_points (n_points).
// Returns n_faces.
// Returns n_faces, or -1 for non-manifold input (a face shared by >2
// elements) — mirroring the NumPy fallback's ValueError instead of
// silently re-pairing (the ctypes wrapper raises).
i64 build_faces(i64 n_elems, i64 n_points, i64 stride,
                const idx* conn, const idx* etypes,
                const idx* nfael, const idx* lnofa, const idx* lpofa,
                i64 max_fpe, i64 max_ppf,
                idx* infael, idx* inpofa, idx* esuel,
                idx* boundary_faces, idx* boundary_points) {
    // Open-addressing table (linear probing): ~3x faster than
    // std::unordered_map for this insert-heavy one-shot workload.
    // Sized from the half-face count: paired entries are consumed, so
    // live entries never exceed the UNIQUE face count (~total_hf/2 on
    // conforming meshes; worst case all-boundary = total_hf -> load
    // factor <= 0.5 at cap ~= total_hf).  At 1.9M tets the dominant
    // cost is PAGE FAULTS on fresh pages, not probing (first call
    // 3.6 s vs 0.8 s with warm pages), so the table is kept in a
    // grow-only thread_local buffer reused across calls and sized as
    // small as the load factor allows.
    i64 total_hf = 0;
    for (i64 e = 0; e < n_elems; ++e) total_hf += nfael[etypes[e]];
    size_t cap = 64;
    // +25% headroom keeps worst-case (all-unique) load factor <= 0.8
    while (cap < (size_t)total_hf + (size_t)total_hf / 4) cap <<= 1;
    const size_t mask = cap - 1;
    struct Slot { FaceKey key; int32_t elem, slot; };  // 24 bytes
    // slot == -2 marks a consumed (already paired) entry.  Raw grow-only
    // thread_local buffer: std::vector::resize value-initializes, which
    // would touch the whole table a second time on top of the memset.
    static thread_local Slot* table = nullptr;
    static thread_local size_t table_cap = 0;
    if (table_cap < cap) {
        ::free(table);
        // 2 MB-aligned + MADV_HUGEPAGE: this environment (a microVM)
        // faults fresh 4 KB pages at as little as ~30 MB/s under host
        // pressure — first-touch of the ~200 MB table dominated the
        // whole build; THP (madvise mode here) cuts the fault count
        // 512x.
        const size_t bytes = ((cap * sizeof(Slot)) + (2u << 20) - 1)
                             & ~(size_t)((2u << 20) - 1);
        table = (Slot*)::aligned_alloc(2u << 20, bytes);
        table_cap = table ? cap : 0;
        if (!table) return -2;  // allocation failure (wrapper raises)
#ifdef __linux__
        ::madvise(table, bytes, MADV_HUGEPAGE);
#endif
    }
    std::memset(table, 0xFF, cap * sizeof(Slot));  // elem = -1
    FaceKeyHash hasher;

    // infael/esuel padding slots (-1) are written inside the walk, on
    // the same cache lines as the real writes, instead of a separate
    // two-array full pass here: fresh-page faults on these ~120 MB
    // arrays dominate a process's first build, not the hash probing.
    std::memset(boundary_points, 0, sizeof(idx) * n_points);

    // The table walk is a dependent random-access chain; batching the key
    // computation and software-prefetching the home slots ahead of the
    // (order-sensitive, strictly sequential) table pass hides most of the
    // DRAM latency on the single host core.
    constexpr int BATCH = 256;
    FaceKey keys[BATCH];
    size_t homes[BATCH];
    idx kpts[BATCH][4];
    int32_t kel[BATCH], ksl[BATCH];

    i64 n_faces = 0;
    i64 e = 0, j = 0;
    while (e < n_elems) {
        int nb = 0;
        while (nb < BATCH && e < n_elems) {
            const i64 t = etypes[e];
            const i64 nf = nfael[t];
            if (j == 0) {           // first visit: init this row's slots
                for (i64 k = 0; k < max_fpe; ++k) {
                    infael[e * max_fpe + k] = -1;
                    esuel[e * max_fpe + k] = -1;
                }
            }
            if (j >= nf) { ++e; j = 0; continue; }
            const idx* row = conn + e * stride;
            idx pts[4] = {-1, -1, -1, -1};
            const i64 npf = lnofa[t * max_fpe + j];
            const idx* lp = lpofa + (t * max_fpe + j) * max_ppf;
            for (i64 k = 0; k < npf; ++k) pts[k] = row[lp[k]];
            idx srt[4] = {pts[0], pts[1], pts[2], pts[3]};
            sort4(srt);
            keys[nb] = make_face_key(srt);
            homes[nb] = hasher(keys[nb]) & mask;
            __builtin_prefetch(&table[homes[nb]], 1, 1);
            kpts[nb][0] = pts[0]; kpts[nb][1] = pts[1];
            kpts[nb][2] = pts[2]; kpts[nb][3] = pts[3];
            kel[nb] = (int32_t)e; ksl[nb] = (int32_t)j;
            ++nb; ++j;
        }
        for (int b = 0; b < nb; ++b) {
            const FaceKey key = keys[b];
            size_t h = homes[b];
            const i64 ee = kel[b], jj = ksl[b];
            while (true) {
                Slot& s = table[h];
                if (s.elem < 0) {                 // new face
                    s.key = key;
                    s.elem = (int32_t)ee; s.slot = (int32_t)jj;
                    const i64 f = n_faces++;
                    infael[ee * max_fpe + jj] = (idx)f;
                    idx* fp = inpofa + f * 4;
                    fp[0] = kpts[b][0]; fp[1] = kpts[b][1];
                    fp[2] = kpts[b][2]; fp[3] = kpts[b][3];
                    boundary_faces[f] = 1;        // cleared when paired
                    break;
                }
                if (s.key == key) {               // second half-face
                    if (s.slot == -2) return -1;  // third: non-manifold
                    const i64 f = infael[s.elem * max_fpe + s.slot];
                    infael[ee * max_fpe + jj] = (idx)f;
                    esuel[ee * max_fpe + jj] = s.elem;
                    esuel[s.elem * max_fpe + s.slot] = (idx)ee;
                    boundary_faces[f] = 0;
                    s.slot = -2;                  // consume the pair
                    break;
                }
                h = (h + 1) & mask;
            }
        }
    }
    for (i64 f = 0; f < n_faces; ++f) {
        if (!boundary_faces[f]) continue;
        const idx* fp = inpofa + f * 4;
        for (i64 k = 0; k < 4 && fp[k] >= 0; ++k) boundary_points[fp[k]] = 1;
    }
    return n_faces;
}

// Faces surrounding each point (reference grid.pyx:347-379).
void build_fsup(i64 n_faces, i64 n_points,
                const idx* inpofa, idx* fsup_ptr, idx* fsup) {
    std::memset(fsup_ptr, 0, sizeof(idx) * (n_points + 1));
    for (i64 f = 0; f < n_faces; ++f) {
        const idx* fp = inpofa + f * 4;
        for (i64 k = 0; k < 4 && fp[k] >= 0; ++k) fsup_ptr[fp[k] + 1]++;
    }
    for (i64 p = 0; p < n_points; ++p) fsup_ptr[p + 1] += fsup_ptr[p];
    for (i64 f = 0; f < n_faces; ++f) {
        const idx* fp = inpofa + f * 4;
        for (i64 k = 0; k < 4 && fp[k] >= 0; ++k)
            fsup[fsup_ptr[fp[k]]++] = (idx)f;
    }
    for (i64 p = n_points; p > 0; --p) fsup_ptr[p] = fsup_ptr[p - 1];
    fsup_ptr[0] = 0;
}

// Elements surrounding each face (reference grid.pyx:381-416).
void build_esuf(i64 n_elems, i64 n_faces, i64 max_fpe,
                const idx* infael, const idx* etypes, const idx* nfael,
                idx* esuf_ptr, idx* esuf) {
    std::memset(esuf_ptr, 0, sizeof(idx) * (n_faces + 1));
    for (i64 e = 0; e < n_elems; ++e) {
        const i64 nf = nfael[etypes[e]];
        for (i64 j = 0; j < nf; ++j)
            esuf_ptr[infael[e * max_fpe + j] + 1]++;
    }
    for (i64 f = 0; f < n_faces; ++f) esuf_ptr[f + 1] += esuf_ptr[f];
    for (i64 e = 0; e < n_elems; ++e) {
        const i64 nf = nfael[etypes[e]];
        for (i64 j = 0; j < nf; ++j)
            esuf[esuf_ptr[infael[e * max_fpe + j]]++] = (idx)e;
    }
    for (i64 f = n_faces; f > 0; --f) esuf_ptr[f] = esuf_ptr[f - 1];
    esuf_ptr[0] = 0;
}

// Element centroids: vertex average in slot order, first `dim`
// coordinates only (reference grid.pyx:669-704).  Bit-identical to the
// NumPy path in _grid/geometry.py (same f64 accumulation order).
void compute_centroids(i64 n_elems, i64 stride,
                       const idx* conn, const idx* etypes, const idx* npoel,
                       const double* coords /*(n_points, 3)*/, i64 dim,
                       double* out /*(n_elems, 3) zeroed by caller*/) {
    for (i64 e = 0; e < n_elems; ++e) {
        const i64 np = npoel[etypes[e]];
        const idx* row = conn + e * stride;
        double acc[3] = {0.0, 0.0, 0.0};
        for (i64 j = 0; j < np; ++j) {
            const double* p = coords + row[j] * 3;
            acc[0] += p[0]; acc[1] += p[1]; acc[2] += p[2];
        }
        const double inv = 1.0 / (double)np;
        double* o = out + e * 3;
        for (i64 c = 0; c < dim; ++c) o[c] = acc[c] * inv;
    }
}

// Face centers + unit normals + areas in one pass
// (reference grid.pyx:706-809).  Normals reproduce the reference's
// float32 intermediate chain (grid.pyx:732-736 declare float scratch)
// unless precise != 0 — matching _grid/geometry.py exactly.
void compute_face_geometry(i64 n_faces, const idx* inpofa /*(n,4)*/,
                           const double* coords, i64 dim, i64 precise,
                           double* centers /*(n,3) zeroed*/,
                           double* normals /*(n,3) zeroed*/,
                           double* areas /*(n)*/) {
    for (i64 f = 0; f < n_faces; ++f) {
        const idx* fp = inpofa + f * 4;
        i64 k = 0;
        double acc[3] = {0.0, 0.0, 0.0};
        for (; k < 4 && fp[k] >= 0; ++k) {
            const double* p = coords + fp[k] * 3;
            acc[0] += p[0]; acc[1] += p[1]; acc[2] += p[2];
        }
        const double inv = 1.0 / (double)k;
        for (i64 c = 0; c < dim; ++c) centers[f * 3 + c] = acc[c] * inv;

        const double* p1 = coords + fp[0] * 3;
        const double* p2 = coords + fp[1] * 3;
        if (dim == 3) {
            const double* p3 = coords + fp[2] * 3;
            if (precise) {
                const double v1[3] = {p1[0] - p2[0], p1[1] - p2[1],
                                      p1[2] - p2[2]};
                const double v2[3] = {p3[0] - p2[0], p3[1] - p2[1],
                                      p3[2] - p2[2]};
                const double nx = v1[1] * v2[2] - v1[2] * v2[1];
                const double ny = v1[2] * v2[0] - v1[0] * v2[2];
                const double nz = v1[0] * v2[1] - v1[1] * v2[0];
                const double nrm = std::sqrt(nx * nx + ny * ny + nz * nz);
                normals[f * 3 + 0] = nx / nrm;
                normals[f * 3 + 1] = ny / nrm;
                normals[f * 3 + 2] = nz / nrm;
                double area = nrm / 2.0;
                if (fp[3] != -1) {
                    const double* p4 = coords + fp[3] * 3;
                    const double w1[3] = {p1[0] - p4[0], p1[1] - p4[1],
                                          p1[2] - p4[2]};
                    const double w2[3] = {p3[0] - p4[0], p3[1] - p4[1],
                                          p3[2] - p4[2]};
                    const double mx = w1[1] * w2[2] - w1[2] * w2[1];
                    const double my = w1[2] * w2[0] - w1[0] * w2[2];
                    const double mz = w1[0] * w2[1] - w1[1] * w2[0];
                    area = (nrm + std::sqrt(mx * mx + my * my + mz * mz))
                           / 2.0;
                }
                areas[f] = area;
            } else {
                const float v1[3] = {(float)(p1[0] - p2[0]),
                                     (float)(p1[1] - p2[1]),
                                     (float)(p1[2] - p2[2])};
                const float v2[3] = {(float)(p3[0] - p2[0]),
                                     (float)(p3[1] - p2[1]),
                                     (float)(p3[2] - p2[2])};
                const float nx = v1[1] * v2[2] - v1[2] * v2[1];
                const float ny = v1[2] * v2[0] - v1[0] * v2[2];
                const float nz = v1[0] * v2[1] - v1[1] * v2[0];
                const float nrm = std::sqrt(nx * nx + ny * ny + nz * nz);
                normals[f * 3 + 0] = (double)(nx / nrm);
                normals[f * 3 + 1] = (double)(ny / nrm);
                normals[f * 3 + 2] = (double)(nz / nrm);
                double area = (double)nrm / 2.0;
                if (fp[3] != -1) {
                    const double* p4 = coords + fp[3] * 3;
                    const float w1[3] = {(float)(p1[0] - p4[0]),
                                         (float)(p1[1] - p4[1]),
                                         (float)(p1[2] - p4[2])};
                    const float w2[3] = {(float)(p3[0] - p4[0]),
                                         (float)(p3[1] - p4[1]),
                                         (float)(p3[2] - p4[2])};
                    const float mx = w1[1] * w2[2] - w1[2] * w2[1];
                    const float my = w1[2] * w2[0] - w1[0] * w2[2];
                    const float mz = w1[0] * w2[1] - w1[1] * w2[0];
                    const float s2 = mx * mx + my * my + mz * mz;
                    area = ((double)nrm + std::sqrt((double)s2)) / 2.0;
                }
                areas[f] = area;
            }
        } else {
            if (precise) {
                const double v1[2] = {p1[0] - p2[0], p1[1] - p2[1]};
                const double nx = -v1[1], ny = v1[0];
                const double nrm = std::sqrt(nx * nx + ny * ny);
                normals[f * 3 + 0] = nx / nrm;
                normals[f * 3 + 1] = ny / nrm;
                areas[f] = nrm;
            } else {
                const float v1[2] = {(float)(p1[0] - p2[0]),
                                     (float)(p1[1] - p2[1])};
                const float nx = -v1[1], ny = v1[0];
                const float nrm = std::sqrt(nx * nx + ny * ny);
                normals[f * 3 + 0] = (double)(nx / nrm);
                normals[f * 3 + 1] = (double)(ny / nrm);
                areas[f] = (double)nrm;
            }
        }
    }
}

// Unique edges by first encounter (reference grid.pyx:527-580).
// Returns n_edges; inedel (n_elems, max_epe), inpoed (cap, 2).
i64 build_edges(i64 n_elems, i64 n_points, i64 stride,
                const idx* conn, const idx* etypes,
                const idx* nedel, const idx* lpoed, i64 max_epe,
                idx* inedel, idx* inpoed) {
    std::unordered_map<i64, i64> seen;  // key = min*(n+2)+max -> edge id
    seen.reserve((size_t)(n_elems * 4));
    std::fill(inedel, inedel + n_elems * max_epe, (i64)-1);
    const i64 base = n_points + 2;
    i64 n_edges = 0;
    for (i64 e = 0; e < n_elems; ++e) {
        const i64 t = etypes[e];
        const i64 ned = nedel[t];
        const idx* row = conn + e * stride;
        for (i64 j = 0; j < ned; ++j) {
            const idx* lp = lpoed + (t * max_epe + j) * 2;
            const i64 a = row[lp[0]], b = row[lp[1]];
            const i64 lo = a < b ? a : b, hi = a < b ? b : a;
            const i64 key = (lo + 1) * base + (hi + 1);
            auto it = seen.find(key);
            i64 id;
            if (it == seen.end()) {
                id = n_edges++;
                seen.emplace(key, id);
                inpoed[id * 2] = (idx)a;  // original orientation
                inpoed[id * 2 + 1] = (idx)b;
            } else {
                id = it->second;
            }
            inedel[e * max_epe + j] = (idx)id;
        }
    }
    return n_edges;
}

}  // extern "C"
