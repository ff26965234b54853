// decimator.cpp — native mesh simplification for the preprocessing pipeline
// (a copy of the JAX package's stinet_tpu/preprocessing/native/decimator.cpp;
// only this header differs, and it compiles to the same code).
//
// Replaces the reference's two vcglib binaries (tridecimator /
// trimesh_clustering, invoked at the reference's preprocessing/
// graph_level_generation.py:248-249,423-424) with a self-contained
// implementation exposing a C API for in-process use via ctypes — no PLY/CSV
// round-trips, and the vertex trace (original vertex -> surviving vertex) is
// produced directly by the collapse bookkeeping instead of being
// reconstructed with a BallTree from a CSV of coordinates (reference
// csv2npy, graph_level_generation.py:135-191).
//
//  * qem_decimate: Garland–Heckbert quadric-error-metric edge collapse with
//    optimal vertex placement (the "-On" behavior) and a face-flip guard,
//    down to a target vertex count.
//  * cluster_decimate: uniform-grid vertex clustering at a given cell size
//    (the trimesh_clustering "-s" behavior); guarantees a plain triangle
//    mesh for subsequent QEM passes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 decimator.cpp -o libdecimator.so
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

// Symmetric 4x4 quadric, 10 coefficients.
struct Quadric {
  double a2 = 0, ab = 0, ac = 0, ad = 0;
  double b2 = 0, bc = 0, bd = 0;
  double c2 = 0, cd = 0;
  double d2 = 0;
  void addPlane(double a, double b, double c, double d, double w = 1.0) {
    a2 += w * a * a; ab += w * a * b; ac += w * a * c; ad += w * a * d;
    b2 += w * b * b; bc += w * b * c; bd += w * b * d;
    c2 += w * c * c; cd += w * c * d;
    d2 += w * d * d;
  }
  void add(const Quadric& o) {
    a2 += o.a2; ab += o.ab; ac += o.ac; ad += o.ad;
    b2 += o.b2; bc += o.bc; bd += o.bd;
    c2 += o.c2; cd += o.cd; d2 += o.d2;
  }
  double eval(const Vec3& v) const {
    return a2 * v.x * v.x + 2 * ab * v.x * v.y + 2 * ac * v.x * v.z +
           2 * ad * v.x + b2 * v.y * v.y + 2 * bc * v.y * v.z + 2 * bd * v.y +
           c2 * v.z * v.z + 2 * cd * v.z + d2;
  }
  // Solve grad Q = 0 (3x3 system); returns false if near-singular.
  bool optimal(Vec3* out) const {
    const double m[9] = {a2, ab, ac, ab, b2, bc, ac, bc, c2};
    const double det = m[0] * (m[4] * m[8] - m[5] * m[7]) -
                       m[1] * (m[3] * m[8] - m[5] * m[6]) +
                       m[2] * (m[3] * m[7] - m[4] * m[6]);
    if (std::fabs(det) < 1e-12) return false;
    const double inv = 1.0 / det;
    const double bx = -ad, by = -bd, bz = -cd;
    out->x = inv * ((m[4] * m[8] - m[5] * m[7]) * bx -
                    (m[1] * m[8] - m[2] * m[7]) * by +
                    (m[1] * m[5] - m[2] * m[4]) * bz);
    out->y = inv * (-(m[3] * m[8] - m[5] * m[6]) * bx +
                    (m[0] * m[8] - m[2] * m[6]) * by -
                    (m[0] * m[5] - m[2] * m[3]) * bz);
    out->z = inv * ((m[3] * m[7] - m[4] * m[6]) * bx -
                    (m[0] * m[7] - m[1] * m[6]) * by +
                    (m[0] * m[4] - m[1] * m[3]) * bz);
    return std::isfinite(out->x) && std::isfinite(out->y) &&
           std::isfinite(out->z);
  }
};

struct Face {
  int v[3];
  bool alive = true;
};

struct HeapEntry {
  double cost;
  int u, v;
  uint32_t version;
  bool operator<(const HeapEntry& o) const { return cost > o.cost; }
};

class QemMesh {
 public:
  QemMesh(int nv, int nf, const double* verts, const int* faces)
      : pos_(nv), parent_(nv), version_(nv, 0), quadric_(nv), alive_(nv, true),
        faces_(nf), vfaces_(nv), neighbors_(nv) {
    for (int i = 0; i < nv; ++i) {
      pos_[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
      parent_[i] = i;
    }
    for (int f = 0; f < nf; ++f) {
      for (int k = 0; k < 3; ++k) faces_[f].v[k] = faces[3 * f + k];
      const int a = faces_[f].v[0], b = faces_[f].v[1], c = faces_[f].v[2];
      if (a == b || b == c || a == c) { faces_[f].alive = false; continue; }
      vfaces_[a].push_back(f); vfaces_[b].push_back(f); vfaces_[c].push_back(f);
      neighbors_[a].insert(b); neighbors_[a].insert(c);
      neighbors_[b].insert(a); neighbors_[b].insert(c);
      neighbors_[c].insert(a); neighbors_[c].insert(b);
      // plane quadric, area-weighted
      const Vec3 n = (pos_[b] - pos_[a]).cross(pos_[c] - pos_[a]);
      const double area2 = n.norm();
      if (area2 < 1e-18) continue;
      const Vec3 un = n * (1.0 / area2);
      const double d = -un.dot(pos_[a]);
      const double w = 0.5 * area2;
      quadric_[a].addPlane(un.x, un.y, un.z, d, w);
      quadric_[b].addPlane(un.x, un.y, un.z, d, w);
      quadric_[c].addPlane(un.x, un.y, un.z, d, w);
    }
    live_vertices_ = nv;
    for (int v = 0; v < nv; ++v)
      if (neighbors_[v].empty()) { alive_[v] = false; --live_vertices_; }
  }

  int find(int v) {
    while (parent_[v] != v) { parent_[v] = parent_[parent_[v]]; v = parent_[v]; }
    return v;
  }

  void decimate(int target_nv) {
    std::priority_queue<HeapEntry> heap;
    const int nv = static_cast<int>(pos_.size());
    for (int u = 0; u < nv; ++u)
      for (int v : neighbors_[u])
        if (u < v) pushEdge(heap, u, v);

    while (live_vertices_ > target_nv && !heap.empty()) {
      HeapEntry e = heap.top();
      heap.pop();
      int u = find(e.u), v = find(e.v);
      if (u == v || !alive_[u] || !alive_[v]) continue;
      if (e.version != version_[e.u] + version_[e.v]) continue;  // stale
      Vec3 target;
      collapseTarget(u, v, &target);
      if (flipsFace(u, v, target) && live_vertices_ > target_nv + 8) {
        // retry later with a strictly growing penalty; once the cost passes
        // 1e18 the edge is permanently rejected instead of re-queued, which
        // bounds the loop (every entry either collapses, goes stale, or is
        // re-pushed finitely many times before crossing the threshold).
        // Clamp at 0 first: Quadric::eval can go slightly NEGATIVE from
        // floating-point cancellation, and a negative cost times 1.5
        // diverges toward -inf — permanently topping the min-heap and
        // spinning decimate() forever.
        if (e.cost < 1e18)
          heap.push({std::max(e.cost, 0.0) * 1.5 + 1e-9, e.u, e.v,
                     version_[e.u] + version_[e.v]});
        continue;
      }
      collapse(u, v, target);
      for (int n : neighbors_[v])
        pushEdge(heap, v, n);
    }
  }

  // Write results; returns live vertex count.
  int extract(double* out_verts, int* out_faces, int* out_nf, int* trace) {
    const int nv = static_cast<int>(pos_.size());
    std::vector<int> remap(nv, -1);
    int out_n = 0;
    for (int v = 0; v < nv; ++v) {
      if (alive_[v] && find(v) == v) {
        remap[v] = out_n;
        out_verts[3 * out_n] = pos_[v].x;
        out_verts[3 * out_n + 1] = pos_[v].y;
        out_verts[3 * out_n + 2] = pos_[v].z;
        ++out_n;
      }
    }
    for (int v = 0; v < nv; ++v) {
      int r = remap[find(v)];
      if (r < 0) {
        // isolated vertex (no neighbors: killed in the constructor with no
        // collapse representative) — trace to the NEAREST survivor, like
        // the reference's BallTree csv2npy reconstruction, instead of an
        // arbitrary vertex-0 that would contaminate its coarse cluster
        double best = 1e300;
        int best_r = 0;
        for (int s = 0; s < nv; ++s) {
          if (remap[s] < 0) continue;
          const Vec3 d = pos_[s] - pos_[v];
          const double dd = d.dot(d);
          if (dd < best) { best = dd; best_r = remap[s]; }
        }
        r = best_r;
      }
      trace[v] = r;
    }
    int fcount = 0;
    for (auto& f : faces_) {
      if (!f.alive) continue;
      int a = remap[find(f.v[0])], b = remap[find(f.v[1])],
          c = remap[find(f.v[2])];
      if (a == b || b == c || a == c || a < 0 || b < 0 || c < 0) continue;
      out_faces[3 * fcount] = a;
      out_faces[3 * fcount + 1] = b;
      out_faces[3 * fcount + 2] = c;
      ++fcount;
    }
    *out_nf = fcount;
    return out_n;
  }

 private:
  void pushEdge(std::priority_queue<HeapEntry>& heap, int u, int v) {
    u = find(u); v = find(v);
    if (u == v || !alive_[u] || !alive_[v]) return;
    Quadric q = quadric_[u];
    q.add(quadric_[v]);
    Vec3 t;
    double cost = candidateCost(q, u, v, &t);
    heap.push({cost, u, v, version_[u] + version_[v]});
  }

  double candidateCost(const Quadric& q, int u, int v, Vec3* t) const {
    Vec3 opt;
    if (q.optimal(&opt)) { *t = opt; return q.eval(opt); }
    const Vec3 mid = (pos_[u] + pos_[v]) * 0.5;
    double cm = q.eval(mid), cu = q.eval(pos_[u]), cv = q.eval(pos_[v]);
    if (cm <= cu && cm <= cv) { *t = mid; return cm; }
    if (cu <= cv) { *t = pos_[u]; return cu; }
    *t = pos_[v]; return cv;
  }

  void collapseTarget(int u, int v, Vec3* t) {
    Quadric q = quadric_[u];
    q.add(quadric_[v]);
    candidateCost(q, u, v, t);
  }

  bool flipsFace(int u, int v, const Vec3& target) {
    for (int who : {u, v}) {
      for (int f : vfaces_[who]) {
        if (!faces_[f].alive) continue;
        int a = find(faces_[f].v[0]), b = find(faces_[f].v[1]),
            c = find(faces_[f].v[2]);
        // faces containing both u and v die; skip them
        bool hasU = (a == u || b == u || c == u);
        bool hasV = (a == v || b == v || c == v);
        if (hasU && hasV) continue;
        Vec3 p[3] = {pos_[a], pos_[b], pos_[c]};
        Vec3 q[3];
        for (int k = 0; k < 3; ++k) {
          int r = (k == 0 ? a : k == 1 ? b : c);
          q[k] = (r == u || r == v) ? target : pos_[r];
        }
        const Vec3 n0 = (p[1] - p[0]).cross(p[2] - p[0]);
        const Vec3 n1 = (q[1] - q[0]).cross(q[2] - q[0]);
        if (n0.dot(n1) < 0) return true;
      }
    }
    return false;
  }

  void collapse(int u, int v, const Vec3& target) {
    // v survives at `target`; u merges into v.
    quadric_[v].add(quadric_[u]);
    pos_[v] = target;
    parent_[u] = v;
    alive_[u] = false;
    ++version_[u];
    ++version_[v];
    --live_vertices_;
    // merge adjacency
    for (int n : neighbors_[u]) {
      int rn = find(n);
      if (rn != v && alive_[rn]) {
        neighbors_[v].insert(rn);
        neighbors_[rn].erase(u);
        neighbors_[rn].insert(v);
      }
    }
    neighbors_[v].erase(u);
    neighbors_[v].erase(v);
    // merge face lists; kill degenerate faces
    for (int f : vfaces_[u]) {
      if (!faces_[f].alive) continue;
      int a = find(faces_[f].v[0]), b = find(faces_[f].v[1]),
          c = find(faces_[f].v[2]);
      if (a == b || b == c || a == c) faces_[f].alive = false;
      else vfaces_[v].push_back(f);
    }
    vfaces_[u].clear();
    neighbors_[u].clear();
  }

  std::vector<Vec3> pos_;
  std::vector<int> parent_;
  std::vector<uint32_t> version_;
  std::vector<Quadric> quadric_;
  std::vector<bool> alive_;
  std::vector<Face> faces_;
  std::vector<std::vector<int>> vfaces_;
  std::vector<std::unordered_set<int>> neighbors_;
  int live_vertices_ = 0;
};

}  // namespace

extern "C" {

// QEM decimation to `target_nv` vertices. Buffers out_verts [nv*3],
// out_faces [nf*3], trace [nv] must be caller-allocated at input size.
// Returns the output vertex count (<= nv); out_nf receives face count.
// Face ids straight from raw mesh files index std::vectors in-process:
// an out-of-range id would be heap corruption, not a recoverable error —
// validate up front and fail the scene (return -1) instead.
static bool faces_in_range(int nv, int nf, const int* faces) {
  for (int i = 0; i < 3 * nf; ++i)
    if (faces[i] < 0 || faces[i] >= nv) return false;
  return true;
}

int qem_decimate(int nv, int nf, const double* verts, const int* faces,
                 int target_nv, double* out_verts, int* out_faces,
                 int* out_nf, int* trace) {
  if (!faces_in_range(nv, nf, faces)) return -1;
  QemMesh mesh(nv, nf, verts, faces);
  mesh.decimate(target_nv);
  return mesh.extract(out_verts, out_faces, out_nf, trace);
}

// Uniform-grid vertex clustering at `cell_size`. Representative position is
// the mean of each cell's vertices. Same buffer contract as qem_decimate.
int cluster_decimate(int nv, int nf, const double* verts, const int* faces,
                     double cell_size, double* out_verts, int* out_faces,
                     int* out_nf, int* trace) {
  if (!faces_in_range(nv, nf, faces)) return -1;
  double mn[3] = {1e30, 1e30, 1e30};
  for (int i = 0; i < nv; ++i)
    for (int k = 0; k < 3; ++k) mn[k] = std::min(mn[k], verts[3 * i + k]);

  // EXACT cell coordinates as the map key (vcglib semantics): a hashed
  // key would let two distinct cells silently merge on collision
  struct CellHash {
    size_t operator()(const std::array<int64_t, 3>& c) const {
      uint64_t h = 1469598103934665603ULL;
      for (int64_t v : c) {
        h ^= static_cast<uint64_t>(v);
        h *= 1099511628211ULL;
      }
      return static_cast<size_t>(h);
    }
  };
  std::unordered_map<std::array<int64_t, 3>, int, CellHash> cells;
  std::vector<double> sums;
  std::vector<int> counts;
  const double inv = 1.0 / cell_size;
  for (int i = 0; i < nv; ++i) {
    const std::array<int64_t, 3> key = {
        static_cast<int64_t>((verts[3 * i] - mn[0]) * inv),
        static_cast<int64_t>((verts[3 * i + 1] - mn[1]) * inv),
        static_cast<int64_t>((verts[3 * i + 2] - mn[2]) * inv)};
    auto it = cells.find(key);
    int id;
    if (it == cells.end()) {
      id = static_cast<int>(counts.size());
      cells.emplace(key, id);
      sums.resize(sums.size() + 3, 0.0);
      counts.push_back(0);
    } else {
      id = it->second;
    }
    trace[i] = id;
    counts[id] += 1;
    for (int k = 0; k < 3; ++k) sums[3 * id + k] += verts[3 * i + k];
  }
  const int out_n = static_cast<int>(counts.size());
  for (int c = 0; c < out_n; ++c)
    for (int k = 0; k < 3; ++k)
      out_verts[3 * c + k] = sums[3 * c + k] / counts[c];

  // Remap faces, drop degenerates, dedupe — by EXACT sorted id triple
  // (a 21-bit-packed key silently collided past 2^21 output clusters)
  struct TriHash {
    size_t operator()(const std::array<int, 3>& t) const {
      uint64_t h = 1469598103934665603ULL;
      for (int v : t) {
        h ^= static_cast<uint64_t>(static_cast<uint32_t>(v));
        h *= 1099511628211ULL;
      }
      return static_cast<size_t>(h);
    }
  };
  std::unordered_set<std::array<int, 3>, TriHash> seen;
  int fcount = 0;
  for (int f = 0; f < nf; ++f) {
    int a = trace[faces[3 * f]], b = trace[faces[3 * f + 1]],
        c = trace[faces[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    int s[3] = {a, b, c};
    std::sort(s, s + 3);
    if (!seen.insert({s[0], s[1], s[2]}).second) continue;
    out_faces[3 * fcount] = a;
    out_faces[3 * fcount + 1] = b;
    out_faces[3 * fcount + 2] = c;
    ++fcount;
  }
  *out_nf = fcount;
  return out_n;
}

// Depth rasterization for observer-visibility masks (the reference's
// observers mode renders with pytorch3d, observed_texture_map_generation.py
// :159-267 — inert there; this is the native replacement). `pts` holds
// projected vertices [nv, 3] = (pixel_x, pixel_y, camera_depth); faces with
// any vertex behind the camera (depth <= 0) are skipped. zbuf [h*w] must be
// pre-filled with +inf by the caller.
void rasterize_depth(int nv, int nf, const double* pts, const int* faces,
                     int width, int height, double* zbuf) {
  for (int f = 0; f < nf; ++f) {
    const int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    if (a < 0 || a >= nv || b < 0 || b >= nv || c < 0 || c >= nv)
      continue;  // corrupt face id: skip rather than read OOB
    const double ax = pts[3 * a], ay = pts[3 * a + 1], az = pts[3 * a + 2];
    const double bx = pts[3 * b], by = pts[3 * b + 1], bz = pts[3 * b + 2];
    const double cx = pts[3 * c], cy = pts[3 * c + 1], cz = pts[3 * c + 2];
    if (az <= 0 || bz <= 0 || cz <= 0) continue;
    const double area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    if (std::abs(area) < 1e-12) continue;
    int x0 = std::max(0, (int)std::floor(std::min({ax, bx, cx})));
    int x1 = std::min(width - 1, (int)std::ceil(std::max({ax, bx, cx})));
    int y0 = std::max(0, (int)std::floor(std::min({ay, by, cy})));
    int y1 = std::min(height - 1, (int)std::ceil(std::max({ay, by, cy})));
    const double inv_area = 1.0 / area;
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        const double px = x + 0.5, py = y + 0.5;
        double w0 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * inv_area;
        double w1 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * inv_area;
        // barycentric w.r.t. vertex order: lambda_c = w0, lambda_a = w1
        const double lc = w0, la = w1, lb = 1.0 - la - lc;
        if (la < -1e-9 || lb < -1e-9 || lc < -1e-9) continue;
        const double z = la * az + lb * bz + lc * cz;
        double& cell = zbuf[y * width + x];
        if (z < cell) cell = z;
      }
    }
  }
}

}  // extern "C"
