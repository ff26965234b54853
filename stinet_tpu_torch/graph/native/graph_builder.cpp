// Native (C++) construction of padded EdgeSet tables for the serving /
// training host path.
//
// Bit-for-bit replacement for the numpy pipeline in
// stinet_tpu/graph/build.py:_pad_edge_set + _build_ell: stable counting
// sorts replace argsorts (the builder is O(E + V) per edge set) and every
// policy decision — the in-degree cap quantile, the spill/bail rules, the
// sender-side hub cap, the windowed banding — reproduces the numpy
// semantics exactly so the two paths are interchangeable (parity-locked by
// tests/test_native_build.py).
//
// The reference performs the analogous collation work in torch-geometric's
// Python collate path (reference utils/data_utils.py:29-42 drives PyG
// Batch.from_data_list); here the padded static-shape tables ARE the
// device format, so the host build is on the serving critical path and is
// worth native treatment (measured: ~10x over the numpy builder at
// ScanNet-scale edge counts).
//
// API: handle-based two-phase (build -> query sizes -> fill) because the
// ELL slot width d_cap and reverse-table width d_out are data-dependent.
// ctypes in-process, no pybind11 (environment constraint).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Built {
  int64_t e = 0;
  int64_t v_pad = 0;
  int32_t trash = 0;
  // dst-sorted valid edges
  std::vector<int32_t> src, dst;
  std::vector<float> degree;  // all-valid-edge in-degree, [v_pad]
  // ELL tables (has_ell == false -> all below empty)
  bool has_ell = false;
  int64_t d_cap = 0, d_out = 0;
  std::vector<int32_t> nbr;       // [v_pad, d_cap]
  std::vector<int32_t> rev;       // [v_pad, d_out]
  std::vector<float> out_degree;  // [v_pad]
  std::vector<float> ell_degree;  // [v_pad]
  std::vector<int32_t> spill_src, spill_dst;
};

// numpy _lerp (numpy/lib/_function_base_impl.py): the t >= 0.5 form is the
// one numpy uses for accuracy; reproduced so int(np.quantile(...)) matches.
double np_lerp(double a, double b, double t) {
  double diff = b - a;
  double r = a + diff * t;
  if (t >= 0.5) r = b - diff * (1.0 - t);
  return r;
}

// np.quantile(values, q) with the default "linear" method, where `values`
// is given as a histogram over 1..max_val (counts of each in-degree value;
// the sorted array is implicit). n = total count (> 0).
double quantile_from_hist(const std::vector<int64_t>& hist, int64_t max_val,
                          int64_t n, double q) {
  double virt = q * static_cast<double>(n - 1);
  int64_t i0 = static_cast<int64_t>(std::floor(virt));
  int64_t i1 = static_cast<int64_t>(std::ceil(virt));
  if (i0 < 0) i0 = 0;
  if (i1 > n - 1) i1 = n - 1;
  double gamma = virt - static_cast<double>(i0);
  // walk the histogram to find sorted[i0] and sorted[i1]
  double a = 0, b = 0;
  int64_t cum = 0;
  for (int64_t v = 1; v <= max_val; ++v) {
    int64_t next = cum + hist[v];
    if (i0 >= cum && i0 < next) a = static_cast<double>(v);
    if (i1 >= cum && i1 < next) {
      b = static_cast<double>(v);
      break;
    }
    cum = next;
  }
  return np_lerp(a, b, gamma);
}

}  // namespace

extern "C" {

// Build the dst-sorted + ELL tables for one edge set. window_halo < 0
// means un-banded. Returns an opaque handle (edge_set_free to release).
void* edge_set_build(const int64_t* src_in, const int64_t* dst_in, int64_t e,
                     int64_t v_pad, int32_t trash, int32_t max_deg,
                     double cap_quantile, double max_spill_frac,
                     int64_t window_halo) {
  // loud validation: file-sourced edge ids out of [0, v_pad) must raise in
  // Python (matching numpy's bincount/scatter errors), not corrupt the heap
  for (int64_t i = 0; i < e; ++i)
    if (src_in[i] < 0 || src_in[i] >= v_pad || dst_in[i] < 0 ||
        dst_in[i] >= v_pad)
      return nullptr;
  Built* B = new Built();
  B->e = e;
  B->v_pad = v_pad;
  B->trash = trash;
  B->degree.assign(v_pad, 0.f);
  if (e == 0) return B;

  // ---- stable counting sort by dst (replaces _stable_argsort_int) ----
  std::vector<int64_t> cnt(v_pad + 1, 0);
  for (int64_t i = 0; i < e; ++i) cnt[dst_in[i] + 1]++;
  for (int64_t v = 0; v < v_pad; ++v) {
    B->degree[v] = static_cast<float>(cnt[v + 1]);
    cnt[v + 1] += cnt[v];
  }
  B->src.resize(e);
  B->dst.resize(e);
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    int64_t p = pos[dst_in[i]]++;
    B->src[p] = static_cast<int32_t>(src_in[i]);
    B->dst[p] = static_cast<int32_t>(dst_in[i]);
  }

  // ---- _build_ell ----
  const std::vector<int32_t>& vs = B->src;
  const std::vector<int32_t>& vd = B->dst;
  std::vector<uint8_t> win_ok(e, 1);
  int64_t n_out_of_window = 0;
  if (window_halo >= 0) {
    for (int64_t i = 0; i < e; ++i) {
      int64_t band = static_cast<int64_t>(vs[i]) - vd[i];
      if (band < 0) band = -band;
      win_ok[i] = band <= window_halo;
      n_out_of_window += !win_ok[i];
    }
  }
  std::vector<int64_t> deg(v_pad, 0);
  int64_t d_in = 0;
  for (int64_t i = 0; i < e; ++i)
    if (win_ok[i]) {
      int64_t d = ++deg[vd[i]];
      if (d > d_in) d_in = d;
    }
  if (d_in == 0) return B;  // no in-window edges: no ELL tables

  // in-degree cap at the quantile of the nonzero-degree distribution
  std::vector<int64_t> hist(d_in + 1, 0);
  int64_t n_nz = 0;
  for (int64_t v = 0; v < v_pad; ++v)
    if (deg[v] > 0) {
      hist[deg[v]]++;
      n_nz++;
    }
  int64_t d_cap = static_cast<int64_t>(
      quantile_from_hist(hist, d_in, n_nz, cap_quantile));  // int(): trunc
  if (d_cap < 4) d_cap = 4;
  if (d_cap > d_in) d_cap = d_in;
  if (d_cap > max_deg) d_cap = max_deg;

  int64_t over_cap = 0;
  for (int64_t v = 0; v < v_pad; ++v)
    if (deg[v] > d_cap) over_cap += deg[v] - d_cap;
  int64_t spill_count = over_cap + n_out_of_window;
  if ((d_cap >= d_in ||
       static_cast<double>(spill_count) > max_spill_frac * e) &&
      window_halo < 0) {
    // spilling at the quantile cap is unnecessary or unprofitable: widen
    // to the full degree where it fits under max_deg; a hub-dominated
    // graph (even max-width ELL leaves >max_spill_frac in COO) gets no ELL
    d_cap = d_in < max_deg ? d_in : max_deg;
    if (d_cap < d_in) {
      int64_t spill_at_cap = 0;
      for (int64_t v = 0; v < v_pad; ++v)
        if (deg[v] > d_cap) spill_at_cap += deg[v] - d_cap;
      if (static_cast<double>(spill_at_cap) > max_spill_frac * e) return B;
    }
  }

  // receiver slots: position within the dst run restricted to in-window
  // edges; keep = in-window and under the cap
  std::vector<uint8_t> keep(e, 0);
  {
    int64_t run_c = 0;
    for (int64_t i = 0; i < e; ++i) {
      if (i == 0 || vd[i] != vd[i - 1]) run_c = 0;
      if (win_ok[i]) {
        keep[i] = run_c < d_cap;
        run_c++;
      }
    }
  }

  // sender-side hub cap: edges past a sender's first max_deg kept slots
  // spill to COO (stable-by-src rank == occurrence order in dst order)
  {
    std::vector<int64_t> sc(v_pad, 0);
    for (int64_t i = 0; i < e; ++i)
      if (keep[i]) {
        if (sc[vs[i]] >= max_deg)
          keep[i] = 0;
        else
          sc[vs[i]]++;
      }
  }

  // fill nbr / ell_degree; receiver slots are re-derived from the FINAL
  // keep mask, which equals numpy's conditional csum_k - run_start_k
  // re-pack in both cases (no sender overflow: kept edges are a per-run
  // prefix of the in-window edges, so ranks coincide; overflow: numpy
  // recomputes exactly this)
  B->has_ell = true;
  B->d_cap = d_cap;
  B->nbr.assign(v_pad * d_cap, trash);
  B->ell_degree.assign(v_pad, 0.f);
  B->out_degree.assign(v_pad, 0.f);
  std::vector<int64_t> od(v_pad, 0);
  int64_t d_out = 0, n_keep = 0;
  {
    int64_t run_c = 0;
    for (int64_t i = 0; i < e; ++i) {
      if (i == 0 || vd[i] != vd[i - 1]) run_c = 0;
      if (keep[i]) {
        B->nbr[static_cast<int64_t>(vd[i]) * d_cap + run_c] = vs[i];
        B->ell_degree[vd[i]] += 1.f;
        run_c++;
        int64_t o = ++od[vs[i]];
        if (o > d_out) d_out = o;
        n_keep++;
      }
    }
  }
  if (n_keep == 0) d_out = 1;   // numpy: d_out = max(out_deg) if kvs else 1
  if (d_out < 1) d_out = 1;     // rev_dst width is max(d_out, 1)
  B->d_out = d_out;
  for (int64_t v = 0; v < v_pad; ++v)
    B->out_degree[v] = static_cast<float>(od[v]);

  // reverse table: sender -> its kept receivers, stable-by-src order
  B->rev.assign(v_pad * d_out, trash);
  {
    std::vector<int64_t> sc(v_pad, 0);
    for (int64_t i = 0; i < e; ++i)
      if (keep[i])
        B->rev[static_cast<int64_t>(vs[i]) * d_out + sc[vs[i]]++] = vd[i];
  }

  // spill: the un-kept edges, still in dst-sorted order
  int64_t n_spill = e - n_keep;
  if (n_spill > 0) {
    B->spill_src.reserve(n_spill);
    B->spill_dst.reserve(n_spill);
    for (int64_t i = 0; i < e; ++i)
      if (!keep[i]) {
        B->spill_src.push_back(vs[i]);
        B->spill_dst.push_back(vd[i]);
      }
  }
  return B;
}

// sizes[0]=has_ell, [1]=d_cap, [2]=d_out, [3]=n_spill
void edge_set_sizes(void* h, int64_t* sizes) {
  Built* B = static_cast<Built*>(h);
  sizes[0] = B->has_ell ? 1 : 0;
  sizes[1] = B->d_cap;
  sizes[2] = B->d_out;
  sizes[3] = static_cast<int64_t>(B->spill_src.size());
}

// Copy into caller-allocated (numpy) buffers. src/dst are padded to e_pad
// and spill to s_pad with trash. ELL pointers may be null when has_ell=0;
// spill pointers may be null when n_spill=0.
void edge_set_fill(void* h, int64_t e_pad, int64_t s_pad, int32_t* src_out,
                   int32_t* dst_out, float* degree_out, int32_t* nbr_out,
                   int32_t* rev_out, float* out_degree_out,
                   float* ell_degree_out, int32_t* spill_src_out,
                   int32_t* spill_dst_out) {
  Built* B = static_cast<Built*>(h);
  const int64_t e = B->e;
  if (e) {
    std::memcpy(src_out, B->src.data(), e * sizeof(int32_t));
    std::memcpy(dst_out, B->dst.data(), e * sizeof(int32_t));
  }
  for (int64_t i = e; i < e_pad; ++i) src_out[i] = B->trash;
  for (int64_t i = e; i < e_pad; ++i) dst_out[i] = B->trash;
  std::memcpy(degree_out, B->degree.data(), B->v_pad * sizeof(float));
  if (B->has_ell) {
    std::memcpy(nbr_out, B->nbr.data(), B->nbr.size() * sizeof(int32_t));
    std::memcpy(rev_out, B->rev.data(), B->rev.size() * sizeof(int32_t));
    std::memcpy(out_degree_out, B->out_degree.data(),
                B->v_pad * sizeof(float));
    std::memcpy(ell_degree_out, B->ell_degree.data(),
                B->v_pad * sizeof(float));
    const int64_t ns = static_cast<int64_t>(B->spill_src.size());
    if (ns) {
      std::memcpy(spill_src_out, B->spill_src.data(), ns * sizeof(int32_t));
      std::memcpy(spill_dst_out, B->spill_dst.data(), ns * sizeof(int32_t));
      for (int64_t i = ns; i < s_pad; ++i) spill_src_out[i] = B->trash;
      for (int64_t i = ns; i < s_pad; ++i) spill_dst_out[i] = B->trash;
    }
  }
}

void edge_set_free(void* h) { delete static_cast<Built*>(h); }

// Children table (coarse -> valid fine vertices) for gather-only pooling,
// mirroring build.py:_build_children. Returns max cluster size (cmax), or
// 0 / a value > max_children to signal "no table" (caller falls back).
// children_out must hold coarse_pad * max_children entries; only the first
// coarse_pad * cmax are written (row stride = cmax).
int64_t build_children(const int32_t* trace, int64_t num_valid_fine,
                       int64_t coarse_pad, int32_t fine_trash,
                       int64_t max_children, int32_t* children_out,
                       float* counts_out) {
  std::vector<int64_t> counts(coarse_pad, 0);
  int64_t cmax = 0;
  for (int64_t i = 0; i < num_valid_fine; ++i) {
    if (trace[i] < 0 || trace[i] >= coarse_pad) return -1;  // caller falls back
    int64_t c = ++counts[trace[i]];
    if (c > cmax) cmax = c;
  }
  if (cmax == 0 || cmax > max_children) return cmax;
  for (int64_t v = 0; v < coarse_pad; ++v) {
    counts_out[v] = static_cast<float>(counts[v]);
    for (int64_t s = counts[v]; s < cmax; ++s)
      children_out[v * cmax + s] = fine_trash;
  }
  std::vector<int64_t> slot(coarse_pad, 0);
  for (int64_t i = 0; i < num_valid_fine; ++i) {
    int64_t c = trace[i];
    children_out[c * cmax + slot[c]++] = static_cast<int32_t>(i);
  }
  return cmax;
}

// ---------------------------------------------------------------------------
// Reusable symmetrized-CSR adjacency handle + bounded-hop BFS disk update,
// the hot primitive of geodesic-disk mask generation
// (preprocessing/masks.py:circle_mask). The BFS touches only the disk
// (O(disk) per seed vs scipy dijkstra's O(N) dist allocation per call) and
// updates the mask in place with max(mask, radius - hopdist), returning how
// many vertices transitioned 0 -> positive so the Python loop can keep its
// exact masked-count accounting without an O(N) rescan per disk.
// ---------------------------------------------------------------------------

namespace {

struct Adj {
  int64_t n = 0;
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  // per-BFS scratch, reused across calls (stamped, never cleared)
  std::vector<int64_t> stamp;
  int64_t cur_stamp = 0;
  std::vector<int32_t> frontier, next;
};

}  // namespace

void* adj_build(const int64_t* src, const int64_t* dst, int64_t e,
                int64_t n) {
  for (int64_t i = 0; i < e; ++i)
    if (src[i] < 0 || src[i] >= n || dst[i] < 0 || dst[i] >= n)
      return nullptr;  // loud ValueError in Python, not heap corruption
  Adj* A = new Adj();
  A->n = n;
  A->indptr.assign(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    A->indptr[src[i] + 1]++;
    A->indptr[dst[i] + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) A->indptr[v + 1] += A->indptr[v];
  A->indices.resize(2 * e);
  std::vector<int64_t> pos(A->indptr.begin(), A->indptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    A->indices[pos[src[i]]++] = static_cast<int32_t>(dst[i]);
    A->indices[pos[dst[i]]++] = static_cast<int32_t>(src[i]);
  }
  A->stamp.assign(n, 0);
  A->cur_stamp = 0;
  return A;
}

// BFS from `seed` to hop depth < radius; mask[v] = max(mask[v],
// radius - hopdist(v)). Returns the count of vertices whose mask went from
// 0 to positive (scipy-dijkstra-parity: hop distance == unweighted
// shortest path; dist == radius contributes update 0 and is skipped).
int64_t adj_disk_update(void* h, int64_t seed, int64_t radius, float* mask) {
  Adj* A = static_cast<Adj*>(h);
  if (seed < 0 || seed >= A->n || radius <= 0) return 0;
  int64_t newly = 0;
  const int64_t s = ++A->cur_stamp;
  A->frontier.clear();
  A->frontier.push_back(static_cast<int32_t>(seed));
  A->stamp[seed] = s;
  for (int64_t depth = 0; depth < radius && !A->frontier.empty(); ++depth) {
    const float val = static_cast<float>(radius - depth);
    A->next.clear();
    for (int32_t v : A->frontier) {
      if (mask[v] == 0.f) newly++;
      if (val > mask[v]) mask[v] = val;
      for (int64_t i = A->indptr[v]; i < A->indptr[v + 1]; ++i) {
        int32_t u = A->indices[i];
        if (A->stamp[u] != s) {
          A->stamp[u] = s;
          A->next.push_back(u);
        }
      }
    }
    A->frontier.swap(A->next);
  }
  return newly;
}

void adj_free(void* h) { delete static_cast<Adj*>(h); }

// Reverse Cuthill-McKee ordering of the symmetrized graph (A + A^T), the
// classic algorithm scipy.sparse.csgraph.reverse_cuthill_mckee implements:
// per connected component, seed at the minimum-degree unvisited vertex, BFS
// appending unvisited neighbors in increasing-degree order, then reverse
// the whole sequence. order_out[new_id] = old_id (scipy's contract; exact
// tie-breaks may differ from scipy — any bandwidth-reducing relabeling is
// equivalent, see build.py:reorder_bandwidth). Returns 0, or -1 on
// out-of-range edge ids (loud error in Python).
int rcm_order(const int64_t* src, const int64_t* dst, int64_t e, int64_t n,
              int32_t* order_out) {
  for (int64_t i = 0; i < e; ++i)
    if (src[i] < 0 || src[i] >= n || dst[i] < 0 || dst[i] >= n) return -1;
  // CSR of the symmetrized graph with per-row dedup
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    cnt[src[i] + 1]++;
    cnt[dst[i] + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) cnt[v + 1] += cnt[v];
  std::vector<int32_t> adj(2 * e);
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    adj[pos[src[i]]++] = static_cast<int32_t>(dst[i]);
    adj[pos[dst[i]]++] = static_cast<int32_t>(src[i]);
  }
  std::vector<int64_t> deg(n);
  std::vector<int64_t> row_end(n);
  for (int64_t v = 0; v < n; ++v) {
    int64_t b = cnt[v], w = b;
    // small rows: insertion-sort then unique in place
    for (int64_t i = b; i < pos[v]; ++i) {
      int32_t x = adj[i];
      int64_t j = w;
      while (j > b && adj[j - 1] > x) {
        adj[j] = adj[j - 1];
        --j;
      }
      adj[j] = x;
      ++w;
    }
    int64_t u = b;
    for (int64_t i = b; i < w; ++i)
      if (i == b || adj[i] != adj[u - 1]) adj[u++] = adj[i];
    row_end[v] = u;
    deg[v] = u - b;
  }

  // vertices in increasing-degree order (counting sort): component seeding
  // walks this list once overall, so fragmented graphs (many components)
  // stay O(n + e) instead of O(n * components)
  std::vector<int32_t> by_deg(n);
  {
    int64_t dmax = 0;
    for (int64_t v = 0; v < n; ++v)
      if (deg[v] > dmax) dmax = deg[v];
    std::vector<int64_t> dc(dmax + 2, 0);
    for (int64_t v = 0; v < n; ++v) dc[deg[v] + 1]++;
    for (int64_t d = 0; d <= dmax; ++d) dc[d + 1] += dc[d];
    for (int64_t v = 0; v < n; ++v)
      by_deg[dc[deg[v]]++] = static_cast<int32_t>(v);
  }

  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<int32_t> nbrs;
  int64_t seed_cursor = 0;
  while (static_cast<int64_t>(order.size()) < n) {
    // component seed: minimum-degree unvisited vertex
    while (visited[by_deg[seed_cursor]]) seed_cursor++;
    int64_t seed = by_deg[seed_cursor];
    visited[seed] = 1;
    order.push_back(static_cast<int32_t>(seed));
    for (size_t head = order.size() - 1; head < order.size(); ++head) {
      int32_t v = order[head];
      nbrs.clear();
      for (int64_t i = cnt[v]; i < row_end[v]; ++i)
        if (!visited[adj[i]]) {
          visited[adj[i]] = 1;
          nbrs.push_back(adj[i]);
        }
      // increasing degree, stable (insertion sort; rows are small)
      for (size_t i = 1; i < nbrs.size(); ++i) {
        int32_t x = nbrs[i];
        size_t j = i;
        while (j > 0 && deg[nbrs[j - 1]] > deg[x]) {
          nbrs[j] = nbrs[j - 1];
          --j;
        }
        nbrs[j] = x;
      }
      for (int32_t x : nbrs) order.push_back(x);
    }
  }
  for (int64_t i = 0; i < n; ++i) order_out[i] = order[n - 1 - i];
  return 0;
}

// Directed deduped edge list from triangle faces, preserving the numpy
// reference order exactly (graph_levels.py:edges_from_faces): the candidate
// sequence is [f01 | f12 | f20 | f10 | f21 | f02] with self-loops dropped,
// deduped to FIRST occurrence (np.unique(key, return_index) + sort(uniq)).
// Order preservation matters: downstream ELL slot assignment follows input
// order, and f32 neighbor-sum rounding depends on it. Hash-set dedup makes
// this O(F) instead of the numpy path's O(F log F) composite-key sort.
// Returns E (<= 6*nf); out_src/out_dst must hold 6*nf entries. Returns -1
// on face ids outside [0, nv).
int64_t edges_from_faces(const int64_t* faces, int64_t nf, int64_t nv,
                         int64_t* out_src, int64_t* out_dst) {
  for (int64_t i = 0; i < 3 * nf; ++i)
    if (faces[i] < 0 || faces[i] >= nv) return -1;
  // open-addressing hash set of src*nv+dst keys
  uint64_t cap = 64;
  while (cap < static_cast<uint64_t>(12 * nf + 16)) cap <<= 1;
  std::vector<int64_t> table(cap, -1);
  const uint64_t mask = cap - 1;
  int64_t e = 0;
  auto try_add = [&](int64_t s, int64_t d) {
    if (s == d) return;
    const int64_t key = s * nv + d;
    // splitmix64-style scramble for probe start
    uint64_t h = static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull;
    h ^= h >> 31;
    uint64_t p = h & mask;
    while (table[p] != -1) {
      if (table[p] == key) return;
      p = (p + 1) & mask;
    }
    table[p] = key;
    out_src[e] = s;
    out_dst[e] = d;
    e++;
  };
  // numpy candidate order: f01, f12, f20, then the reversed blocks
  for (int64_t i = 0; i < nf; ++i) try_add(faces[3 * i], faces[3 * i + 1]);
  for (int64_t i = 0; i < nf; ++i) try_add(faces[3 * i + 1], faces[3 * i + 2]);
  for (int64_t i = 0; i < nf; ++i) try_add(faces[3 * i + 2], faces[3 * i]);
  for (int64_t i = 0; i < nf; ++i) try_add(faces[3 * i + 1], faces[3 * i]);
  for (int64_t i = 0; i < nf; ++i) try_add(faces[3 * i + 2], faces[3 * i + 1]);
  for (int64_t i = 0; i < nf; ++i) try_add(faces[3 * i], faces[3 * i + 2]);
  return e;
}

}  // extern "C"
