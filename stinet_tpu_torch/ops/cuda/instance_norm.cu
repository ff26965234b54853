// Masked instance norm over one graph or a batch of G graphs, f32, in two
// launches a call.
//
// Graph g's rows are [b_g, e_g): the run of graph_id == g below nv =
// num_valid (one graph: [0, nv)). For each graph g and channel c:
//
//   n        = max(e_g - b_g, 1)
//   mean[c]  = sum_{b_g <= r < e_g} x[r, c] / n
//   var[c]   = sum_{b_g <= r < e_g} (x[r, c] - mean[c])^2 / n    (centered)
//   out[r, c] = (x[r, c] - mean[c]) / sqrt(var[c] + eps) on g's rows; the
//               other rows (r >= nv, or graph_id[r] == G) are 0
//
// Replaces the TPU kernel K2, pallas_instance_norm
// (stinet_tpu/ops/pallas/instance_norm.py:77, _forward :56-73, kernel
// :26-53), which normalizes one graph, and the model's multi-graph path,
// stinet_tpu/ops/norms.py:99-104 (XLA in JAX), which batched serving runs.
// K2 takes the variance as sumsq/n - mean^2; the model's function,
// masked_instance_norm (norms.py:79-104), takes the centered variance, and
// this kernel computes that.
//
// graph_id ([V] int32) must be non-decreasing within [0, G]: graph g's valid
// rows are one contiguous run, in g order, and pad rows carry G, as
// graph/build.py lays a batch out. The second launch reads graph_id of every
// row and traps otherwise.
//
// Bound: bytes. The least traffic is x read once and out written once.
// Here x is read twice, once by each launch; the second read finds an
// activation of one flagship scene (under 20 MB) still in the 50 MB L2.
// About 9 flops per element.
//
// Design. The TPU kernel carried its column sums across a sequential grid
// in VMEM. Blocks on the card run in no order, so:
//
// Launch 1, instance_norm_stats. The rows [0, nv) are cut into chunks of
// 256 rows (512 when V > 32768, so that a large level leaves few partials);
// a block of 256 threads takes one chunk and a tile of 32 columns, loads
// its part of x once into registers (16-byte loads when C % 4 == 0 and the
// rows are aligned, 8 or 16 of them in flight a thread, none waiting for
// graph_id), and forms the chunk's column sums, from them the chunk's own
// mean, and from the registers again M2 = sum (x - chunk mean)^2. It writes
// (sum, M2) to slot chunk + g of the partials. A chunk that graph_id steps
// inside is summed one graph's part at a time (the steps found by binary
// search inside the chunk); since graph_id does not decrease, chunk + g
// names each (chunk, graph) pair once, and the rows a part holds follow
// from the run starts, so no count is stored. The block whose chunk holds
// the row where graph_id steps past g writes that row as start[g] (the
// block of the last valid row writes nv for the graphs after its own), so
// the runs are found in the same pass, with no launch and no search of
// their own. Then the block takes a ticket from its column tile's counter.
// The block that draws the last ticket of a tile merges that tile's
// columns, min(G, 8) graphs side by side, each by its share of the block's
// 32 merge lanes (8 without 16-byte loads): lane l of a graph's L lanes
// sums the graph's parts l, l + L, ... in order, then the L lane sums are
// added in order, by Chan's formula:
//
//   mean = sum_k sum_k / n
//   var  = (sum_k M2_k + sum_k n_k (sum_k / n_k - mean)^2) / n
//
// which is the centered variance in exact arithmetic, and as safe as two
// passes when the mean is large against the spread. It writes mean and
// 1 / sqrt(var + eps) per (graph, column) and sets the counter back to 0.
// The merge is the serial tail of the launch: a graph costs it two round
// trips to L2 whatever its size, which is why graphs are merged side by
// side and a large level gets the larger chunks.
//
// Launch 2, instance_norm_apply: one pass, out = (x - mean) * inv_std with
// 16-byte loads and stores, a thread's columns fixed (no divide), pad rows
// written as 0; a row's graph is graph_id[r].
//
// Every sum has a fixed order: a thread's rows in order, the row lanes of a
// warp by an xor butterfly (a + b is b + a bit for bit, so every lane holds
// the same value), the 8 warps in order, the merge as above (L depends on
// G, C and the alignment only). The ticket is the only atomic, and no sum
// goes through it: whichever block is last reads the same partials and
// adds them in the same order, so the same inputs give the same bits on
// every run. The counters live in a zeroed buffer the caller keeps per
// device and stream (calls on one stream do not overlap), not in the
// per-call scratch, which nobody zeroes. With one graph and graph_id given,
// every chunk is one part of graph 0 and the run is [0, nv): the bits of
// the entry without graph_id. num_valid is read from device memory (as the
// TPU kernel's scalar prefetch did), so the caller never waits for the
// device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 32;      // columns a block covers
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = kThreads / (kTileCols / 4);   // the merge's, at most
constexpr int kRowsSmall = 256;    // rows a chunk, V <= kLargeFrom
constexpr int kRowsLarge = 512;    // rows a chunk beyond
constexpr int kLargeFrom = 32768;
constexpr int kApplyRows = 128;    // rows a block of the second launch
constexpr int kMaxGraphs = 65535;
constexpr int kMaxColTiles = 4096;   // ticket counters the caller keeps
constexpr unsigned kFullWarp = 0xffffffffu;

// Partial sums of a block for its 32 columns, one row a warp or merge lane.
using Red = float[kMaxLanes][kTileCols];

int chunk_rows(int V) { return V <= kLargeFrom ? kRowsSmall : kRowsLarge; }

__device__ __forceinline__ int valid_rows(const int* num_valid, int V) {
  return min(max(*num_valid, 0), V);
}

// The first row in [lo, hi) whose graph_id is >= g, or hi.
__device__ __forceinline__ int lower_bound(const int* graph_id, int lo, int hi,
                                           int g) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (graph_id[mid] < g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// As load_row, for what other blocks of this launch wrote: from L2.
template <int VEC>
__device__ __forceinline__ void load_fresh(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// The block's total of `part` for this thread's VEC columns, the same bits
// in every thread: the row lanes of a warp (the lanes that share a column)
// by an xor butterfly, then the warps in order through `red`.
template <int VEC>
__device__ __forceinline__ void block_total(float (&part)[VEC],
                                            Red& red, int tx) {
  constexpr int TX = kTileCols / VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
#pragma unroll
    for (int off = TX; off < 32; off *= 2) {
      part[j] += __shfl_xor_sync(kFullWarp, part[j], off);
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < TX) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[warp][tx * VEC + j] = part[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][tx * VEC + j];
    part[j] = t;
  }
}

// How the 256 threads of a block cover a chunk of R rows x 32 columns.
template <int VEC, int R>
struct Tile {
  static constexpr int TX = kTileCols / VEC;   // threads across the columns
  static constexpr int TY = kThreads / TX;     // row lanes
  static constexpr int RPT = R / TY;           // rows a thread holds
};

// This thread's part of the chunk [r0, r1), for the block's tile of columns,
// into v: 0 beyond r1 and beyond C. Every load starts before any is used
// and none waits for graph_id.
template <int VEC, int R>
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ x, int C, int r0, int r1,
    float (&v)[Tile<VEC, R>::RPT][VEC]) {
  using T = Tile<VEC, R>;
  const int tx = threadIdx.x % T::TX;
  const int ty = threadIdx.x / T::TX;
  const int c0 = blockIdx.y * kTileCols + tx * VEC;
#pragma unroll
  for (int i = 0; i < T::RPT; ++i) {
    const int r = r0 + ty + T::TY * i;
    if (c0 < C && r < r1) {   // VEC == 4 only when C % 4 == 0
      load_row<VEC>(x + static_cast<int64_t>(r) * C + c0, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
  }
}

// (sum, M2) of rows [a, b) of the chunk that starts at r0 and that v holds,
// for the block's tile of columns, into slot `slot`. Every thread of the
// block calls it with the same arguments.
template <int VEC, int R>
__device__ __forceinline__ void part_stats(
    float (&v)[Tile<VEC, R>::RPT][VEC], int C, int r0, int a, int b,
    int64_t slot, float* psum, float* pm2, Red& red_sum, Red& red_m2) {
  constexpr int TX = Tile<VEC, R>::TX;
  constexpr int TY = Tile<VEC, R>::TY;
  constexpr int RPT = Tile<VEC, R>::RPT;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int c0 = blockIdx.y * kTileCols + tx * VEC;
  const bool col_ok = c0 < C;
  float s[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + TY * i;
    const bool live = r >= a && r < b;
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] += live ? v[i][j] : 0.f;
  }
  block_total<VEC>(s, red_sum, tx);
  const float n = static_cast<float>(b - a);
  float m2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) m2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= a && r < b) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[i][j] - s[j] / n;
        m2[j] += d * d;
      }
    }
  }
  block_total<VEC>(m2, red_m2, tx);
  if (threadIdx.x < TX && col_ok) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      psum[slot * C + c0 + j] = s[j];
      pm2[slot * C + c0 + j] = m2[j];
    }
  }
}

// The sum of rows [first, first + L) of `red` at column `col`, in row order.
// One graph takes all TY rows: that loop is unrolled (the same adds in the
// same order).
template <int TY>
__device__ __forceinline__ float lanes_total(const Red& red, int first, int L,
                                             int col) {
  float total = 0.f;
  if (L == TY) {
#pragma unroll
    for (int w = 0; w < TY; ++w) total += red[w][col];
  } else {
#pragma unroll 4
    for (int w = 0; w < L; ++w) total += red[first + w][col];
  }
  return total;
}

// The last block of a column tile: mean and inv_std of every graph for the
// tile's columns from the partials. The threads are laid out as over a
// chunk: TX across the columns, VEC columns each, and TY merge lanes (32
// with 16-byte loads, 8 without). Q = min(G, 8) graphs, rounded down to a
// power of two, are merged at once, each by L = TY / Q lanes: lane l takes
// the graph's parts l, l + L, ... in order, then the graph's lanes are added
// in order. (Each graph costs two round trips to L2, whatever its size, so a
// batch is merged side by side.)
template <int VEC, int R>
__device__ __forceinline__ void merge_tile(
    const int* __restrict__ graph_id, int G, int nv, int C, float eps,
    const float* psum, const float* pm2, float* mean, float* inv_std,
    const int* starts, Red& red_sum, Red& red_m2) {
  constexpr int TX = Tile<VEC, R>::TX;
  constexpr int TY = Tile<VEC, R>::TY;
  const int Q = G >= 8 ? 8 : G >= 4 ? 4 : G >= 2 ? 2 : 1;
  const int L = TY / Q;
  const int tx = threadIdx.x % TX;
  const int lane = threadIdx.x / TX;
  const int q = lane / L;   // which of the Q graphs
  const int l = lane % L;   // which of its lanes
  const int c0 = blockIdx.y * kTileCols + tx * VEC;
  const int* st = starts + static_cast<int64_t>(blockIdx.y) * (G + 1);
  for (int g0 = 0; g0 < G; g0 += Q) {
    const int g = g0 + q;
    const bool live = g < G && c0 < C;
    // clipped: nothing wrote the starts of an empty batch, and a graph_id
    // out of order (which launch 2 traps on) leaves any number there
    int b = 0, e = nv;
    if (graph_id != nullptr && g < G) {
      b = min(max(__ldcg(st + g), 0), nv);
      e = min(max(__ldcg(st + g + 1), 0), nv);
    }
    const float n = fmaxf(static_cast<float>(e - b), 1.f);
    const int k_lo = b / R;
    const int k_hi = b < e ? (e - 1) / R : k_lo - 1;
    float acc[VEC], m[VEC], t[VEC], u[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    if (live) {
      for (int k = k_lo + l; k <= k_hi; k += L) {
        load_fresh<VEC>(psum + static_cast<int64_t>(k + g) * C + c0, t);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += t[j];
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) red_sum[lane][tx * VEC + j] = acc[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = lanes_total<TY>(red_sum, q * L, L, tx * VEC + j) / n;
      acc[j] = 0.f;
    }
    if (live) {
      for (int k = k_lo + l; k <= k_hi; k += L) {
        const float n_k =
            static_cast<float>(min((k + 1) * R, e) - max(k * R, b));
        const int64_t at = static_cast<int64_t>(k + g) * C + c0;
        load_fresh<VEC>(psum + at, t);
        load_fresh<VEC>(pm2 + at, u);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = t[j] / n_k - m[j];
          acc[j] += u[j] + n_k * d * d;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) red_m2[lane][tx * VEC + j] = acc[j];
    __syncthreads();
    if (l == 0 && live) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float total = lanes_total<TY>(red_m2, q * L, L, tx * VEC + j);
        mean[static_cast<int64_t>(g) * C + c0 + j] = m[j];
        inv_std[static_cast<int64_t>(g) * C + c0 + j] =
            1.f / sqrtf(total / n + eps);
      }
    }
  }
}

// Launch 1. Grid: (chunks of V, column tiles). graph_id == null: one graph.
template <int VEC, int R>
__global__ void __launch_bounds__(kThreads) instance_norm_stats(
    const float* __restrict__ x, const int* __restrict__ num_valid,
    const int* __restrict__ graph_id, int G, int V, int C, float eps,
    float* psum, float* pm2, float* mean, float* inv_std, int* starts,
    unsigned* tickets) {
  __shared__ Red red_sum;
  __shared__ Red red_m2;
  __shared__ bool is_last;
  const int nv = valid_rows(num_valid, V);
  const int k = blockIdx.x;
  const int r0 = k * R;
  const int r1 = min(r0 + R, nv);
  if (r0 < r1) {
    float v[Tile<VEC, R>::RPT][VEC];
    load_chunk<VEC, R>(x, C, r0, r1, v);
    int g_lo = 0, g_hi = 0;
    if (graph_id != nullptr) {
      g_lo = min(max(graph_id[r0], 0), G);
      g_hi = min(max(graph_id[r1 - 1], 0), G);
      // the run starts this chunk holds: start[g] is the first valid row
      // whose graph_id is >= g, or nv. graph_id steps past each g in [0, G]
      // in one chunk, or stays below it to the last valid row, so each
      // start is written once for this column tile.
      int* st = starts + static_cast<int64_t>(blockIdx.y) * (G + 1);
      const int prev = r0 == 0 ? -1 : min(max(graph_id[r0 - 1], 0), G);
      for (int g = prev + 1 + threadIdx.x; g <= g_hi; g += kThreads) {
        st[g] = lower_bound(graph_id, r0, r1, g);
      }
      if (r1 == nv) {
        for (int g = g_hi + 1 + threadIdx.x; g <= G; g += kThreads) {
          st[g] = nv;
        }
      }
    }
    for (int g = g_lo; g <= g_hi; ++g) {
      int a = r0, b = r1;
      if (g_lo != g_hi) {
        a = lower_bound(graph_id, r0, r1, g);
        b = lower_bound(graph_id, a, r1, g + 1);
      }
      if (g < G && a < b) {   // rows with graph_id == G are in no graph
        part_stats<VEC, R>(v, C, r0, a, b, static_cast<int64_t>(k) + g, psum,
                           pm2, red_sum, red_m2);
      }
    }
  }
  // publish the partials, then take a ticket; the last block of this column
  // tile merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(&tickets[blockIdx.y], 1u);
    is_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  merge_tile<VEC, R>(graph_id, G, nv, C, eps, psum, pm2, mean, inv_std,
                     starts, red_sum, red_m2);
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

// Launch 2. Grid: (blocks of kApplyRows rows, column tiles).
template <int VEC>
__global__ void __launch_bounds__(kThreads) instance_norm_apply(
    const float* __restrict__ x, const int* __restrict__ num_valid,
    const int* __restrict__ graph_id, int G, const float* __restrict__ mean,
    const float* __restrict__ inv_std, float* __restrict__ out, int V,
    int C) {
  constexpr int TX = kTileCols / VEC;
  constexpr int TY = kThreads / TX;
  constexpr int RPT = kApplyRows / TY;
  const int nv = valid_rows(num_valid, V);
  const int base = blockIdx.x * kApplyRows;
  if (graph_id != nullptr && blockIdx.y == 0 && threadIdx.x < kApplyRows) {
    const int r = base + threadIdx.x;
    if (r < V) {
      const int gid = graph_id[r];
      const int prev = r == 0 ? 0 : graph_id[r - 1];
      if (gid < prev || gid < 0 || gid > G) __trap();
    }
  }
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int c0 = blockIdx.y * kTileCols + tx * VEC;
  if (c0 >= C) return;
  float m[VEC], s[VEC];
  int have = -1;   // the graph whose statistics m and s hold
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = base + ty + TY * i;
    if (r >= V) break;
    int g = 0;
    bool valid = r < nv;
    if (graph_id != nullptr && valid) {
      g = graph_id[r];
      valid = g >= 0 && g < G;
    }
    float v[VEC];
    if (valid) {
      load_row<VEC>(x + static_cast<int64_t>(r) * C + c0, v);
      if (g != have) {
        load_row<VEC>(mean + static_cast<int64_t>(g) * C + c0, m);
        load_row<VEC>(inv_std + static_cast<int64_t>(g) * C + c0, s);
        have = g;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = (v[j] - m[j]) * s[j];
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = 0.f;
    }
    store_row<VEC>(out + static_cast<int64_t>(r) * C + c0, v);
  }
}

int64_t chunks_of(int V) {
  const int R = chunk_rows(V);
  return (static_cast<int64_t>(V) + R - 1) / R;
}

int64_t col_tiles(int C) { return (C + kTileCols - 1) / kTileCols; }

// Floats of scratch for G graphs of [V, C]: (sum, M2) for chunks + G slots
// of C columns, mean and inv_std per graph and column, then G + 1 run
// starts (int32, the width of a float) for each column tile.
int64_t scratch_floats(int V, int C, int G) {
  return 2 * (chunks_of(V) + G) * C + 2 * static_cast<int64_t>(G) * C +
         col_tiles(C) * (static_cast<int64_t>(G) + 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int VEC>
void launch_both(const float* x, const int* num_valid, const int* graph_id,
                 int G, float* out, float* psum, float* pm2, float* mean,
                 float* inv_std, int* starts, unsigned* tickets, int V, int C,
                 float eps, cudaStream_t stream) {
  const dim3 stats_grid(static_cast<unsigned>(chunks_of(V)),
                        static_cast<unsigned>(col_tiles(C)));
  if (chunk_rows(V) == kRowsSmall) {
    instance_norm_stats<VEC, kRowsSmall><<<stats_grid, kThreads, 0, stream>>>(
        x, num_valid, graph_id, G, V, C, eps, psum, pm2, mean, inv_std,
        starts, tickets);
  } else {
    instance_norm_stats<VEC, kRowsLarge><<<stats_grid, kThreads, 0, stream>>>(
        x, num_valid, graph_id, G, V, C, eps, psum, pm2, mean, inv_std,
        starts, tickets);
  }
  const dim3 apply_grid((V + kApplyRows - 1) / kApplyRows,
                        static_cast<unsigned>(col_tiles(C)));
  instance_norm_apply<VEC><<<apply_grid, kThreads, 0, stream>>>(
      x, num_valid, graph_id, G, mean, inv_std, out, V, C);
}

int launch(const float* x, const int* num_valid, const int* graph_id, int G,
           float* out, float* scratch, int64_t scratch_given,
           unsigned* tickets, int V, int C, float eps, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (G < 1 || G > kMaxGraphs) return cudaErrorInvalidValue;
  if (V <= 0 || C <= 0) return cudaSuccess;
  if (col_tiles(C) > kMaxColTiles) return cudaErrorInvalidValue;
  if (scratch_given < scratch_floats(V, C, G)) return cudaErrorInvalidValue;
  const int64_t slots = chunks_of(V) + G;
  float* psum = scratch;
  float* pm2 = psum + slots * C;
  float* mean = pm2 + slots * C;
  float* inv_std = mean + static_cast<int64_t>(G) * C;
  int* starts = reinterpret_cast<int*>(inv_std + static_cast<int64_t>(G) * C);
  if (C % 4 == 0 && aligned16(x) && aligned16(out)) {
    launch_both<4>(x, num_valid, graph_id, G, out, psum, pm2, mean, inv_std,
                   starts, tickets, V, C, eps, stream);
  } else {
    launch_both<1>(x, num_valid, graph_id, G, out, psum, pm2, mean, inv_std,
                   starts, tickets, V, C, eps, stream);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One graph. x, out: [V, C] f32; num_valid: one int32 in device memory;
// scratch: `scratch_given` floats, at least scratch_floats(V, C, 1), which
// the caller works out itself (a smaller one is refused);
// tickets: 4096 uint32 that are 0 and that no other stream uses (left 0).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int masked_instance_norm_f32(const float* x, const int* num_valid,
                                        float* out, float* scratch,
                                        int64_t scratch_given,
                                        unsigned* tickets, int V, int C,
                                        float eps, int device,
                                        cudaStream_t stream) {
  return launch(x, num_valid, nullptr, 1, out, scratch, scratch_given,
                tickets, V, C, eps, device, stream);
}

// G graphs. As masked_instance_norm_f32, with graph_id: [V] int32,
// non-decreasing, pad rows = G; scratch: scratch_floats(V, C, G).
extern "C" int masked_instance_norm_multigraph_f32(
    const float* x, const int* num_valid, const int* graph_id, float* out,
    float* scratch, int64_t scratch_given, unsigned* tickets, int V, int C,
    int G, float eps, int device, cudaStream_t stream) {
  return launch(x, num_valid, graph_id, G, out, scratch, scratch_given,
                tickets, V, C, eps, device, stream);
}
