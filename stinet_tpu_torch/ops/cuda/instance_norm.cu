// Masked instance norm over one graph or a batch of G graphs, f32.
//
// Graph g's rows are [b_g, e_g) = [min(start[g], nv), min(start[g+1], nv)),
// where nv = num_valid and start[g] is the first row whose graph_id is >= g
// (one graph: [0, nv)). For each graph g and channel c:
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
// graph_id ([V] int32) must be non-decreasing: graph g's valid rows are one
// contiguous run, in g order, and pad rows carry G, as the graph builder
// lays a batch out. The kernel that finds the runs traps otherwise.
//
// Bound: bytes. The least traffic is x read once and out written once; the
// three passes here read x three times (the second and third reads partly
// from the 50 MB L2, which holds a whole flagship activation). About 7
// flops per element.
//
// Design: the TPU kernel carried its column sums across a sequential grid
// in VMEM. Blocks on the card run in no order, so each reduction is two
// steps with no atomics, and the result does not change from run to run:
// blocks of 32 columns x 8 row lanes sum a chunk of 256 rows of one graph
// each into a partial [chunks, C]; then one thread per (graph, column) sums
// that graph's partials in chunk order. Done once for the mean and once for
// the centered sum of squares, then one elementwise pass normalizes and
// zeroes the pad rows. num_valid is read from device memory (as the TPU
// kernel's scalar prefetch did), so the caller never waits for the device.
//
// A batch's runs are found on the device from graph_id, and so is each
// graph's first chunk: graph g owns chunks [cstart[g], cstart[g+1]), one
// for each 256 of its rows. Since sum_g ceil(n_g / 256) <= ceil(nv / 256)
// + G, a grid of chunks_of(V) + G blocks covers every batch, and a block
// finds its graph by a binary search over cstart. With one graph the
// chunks, and every sum's order, are those of the single-graph launch, so
// G = 1 gives its bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerChunk = 256;
constexpr int kCols = 32;   // columns per block (one warp across a row)
constexpr int kLanes = 8;   // row lanes per block
constexpr int kMaxGraphs = 65535;   // the finalize grid's y extent

struct Range {
  int begin, end;
};

__device__ __forceinline__ int valid_rows(const int* num_valid, int V) {
  return min(max(*num_valid, 0), V);
}

__device__ __forceinline__ int chunks_in(int rows) {
  return (rows + kRowsPerChunk - 1) / kRowsPerChunk;
}

// The valid rows of graph g: [0, nv) for one graph (start == null), else
// its run of graph_id clipped to the valid rows.
__device__ __forceinline__ Range graph_rows(const int* num_valid,
                                            const int* start, int g, int V) {
  const int nv = valid_rows(num_valid, V);
  if (start == nullptr) return {0, nv};
  return {min(start[g], nv), min(start[g + 1], nv)};
}

// The chunks of graph g: [0, ceil(nv / 256)) for one graph (cstart == null).
__device__ __forceinline__ Range graph_chunks(const int* num_valid,
                                              const int* cstart, int g,
                                              int V) {
  if (cstart == nullptr) return {0, chunks_in(valid_rows(num_valid, V))};
  return {cstart[g], cstart[g + 1]};
}

// start[g] = the first row whose graph_id is >= g, for g in [0, G]: each
// entry is written once, by the row where graph_id steps past it (or the
// last row). Traps unless graph_id is non-decreasing within [0, G].
__global__ void run_starts(const int* __restrict__ graph_id, int V, int G,
                           int* __restrict__ start) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < V;
       r += gridDim.x * blockDim.x) {
    const int gid = graph_id[r];
    const int prev = r == 0 ? -1 : graph_id[r - 1];
    if (gid < prev || gid < 0 || gid > G) __trap();
    for (int g = prev + 1; g <= gid; ++g) start[g] = r;
    if (r == V - 1) {
      for (int g = gid + 1; g <= G; ++g) start[g] = V;
    }
  }
}

// cstart[g] = sum_{g' < g} ceil(n_g' / 256), for g in [0, G]; one thread,
// G steps (a batch holds few graphs).
__global__ void chunk_starts(const int* __restrict__ num_valid,
                             const int* __restrict__ start, int V, int G,
                             int* __restrict__ cstart) {
  int k = 0;
  for (int g = 0; g < G; ++g) {
    cstart[g] = k;
    const Range rows = graph_rows(num_valid, start, g, V);
    k += chunks_in(rows.end - rows.begin);
  }
  cstart[G] = k;
}

// partial[k, c] = sum over the rows of chunk k of x (mean == null) or of
// (x - mean[g, c])^2, where g is the graph that owns chunk k
__global__ void column_partials(const float* __restrict__ x,
                                const int* __restrict__ num_valid,
                                const int* __restrict__ start,
                                const int* __restrict__ cstart, int G,
                                const float* __restrict__ mean,
                                float* __restrict__ partial, int V, int C) {
  __shared__ float lanes[kLanes][kCols];
  const int k = blockIdx.x;
  int g = 0;
  if (cstart != nullptr) {
    if (k >= cstart[G]) return;
    // the last graph whose first chunk is <= k (empty graphs own none)
    int lo = 0, hi = G;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (cstart[mid] <= k) lo = mid; else hi = mid;
    }
    g = lo;
  }
  const Range chunks = graph_chunks(num_valid, cstart, g, V);
  if (k >= chunks.end) return;
  const Range rows = graph_rows(num_valid, start, g, V);
  const int c = blockIdx.y * kCols + threadIdx.x;
  const int r0 = rows.begin + (k - chunks.begin) * kRowsPerChunk;
  const int r1 = min(r0 + kRowsPerChunk, rows.end);
  float s = 0.f;
  if (c < C) {
    const float m = mean ? mean[static_cast<int64_t>(g) * C + c] : 0.f;
    for (int r = r0 + threadIdx.y; r < r1; r += kLanes) {
      const float v = x[static_cast<int64_t>(r) * C + c];
      if (mean) {
        const float d = v - m;
        s += d * d;
      } else {
        s += v;
      }
    }
  }
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.f;
    for (int i = 0; i < kLanes; ++i) t += lanes[i][threadIdx.x];
    partial[static_cast<int64_t>(k) * C + c] = t;
  }
}

// stat[g, c] = sum_k partial[k, c] / n           (inv_std == false: the mean)
// stat[g, c] = 1 / sqrt(sum_k partial / n + eps) (inv_std == true)
// over graph g's chunks k, in order
__global__ void finalize(const float* __restrict__ partial,
                         const int* __restrict__ num_valid,
                         const int* __restrict__ start,
                         const int* __restrict__ cstart, int V, int C,
                         float eps, bool inv_std, float* __restrict__ stat) {
  const int g = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const Range chunks = graph_chunks(num_valid, cstart, g, V);
  float s = 0.f;
  for (int k = chunks.begin; k < chunks.end; ++k) {
    s += partial[static_cast<int64_t>(k) * C + c];
  }
  const Range rows = graph_rows(num_valid, start, g, V);
  const float n = fmaxf(static_cast<float>(rows.end - rows.begin), 1.f);
  const float m = s / n;
  stat[static_cast<int64_t>(g) * C + c] = inv_std ? 1.f / sqrtf(m + eps) : m;
}

// graph_id == null: one graph, rows [0, nv)
__global__ void normalize_rows(const float* __restrict__ x,
                               const int* __restrict__ num_valid,
                               const int* __restrict__ graph_id, int G,
                               const float* __restrict__ mean,
                               const float* __restrict__ inv_std,
                               float* __restrict__ out, int V, int C) {
  const int nv = valid_rows(num_valid, V);
  const int64_t total = static_cast<int64_t>(V) * C;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / C);
    const int c = static_cast<int>(i - static_cast<int64_t>(r) * C);
    int g = 0;
    bool valid = r < nv;
    if (graph_id) {
      g = graph_id[r];
      valid = valid && g < G;
    }
    const int64_t k = static_cast<int64_t>(valid ? g : 0) * C + c;
    out[i] = valid ? (x[i] - mean[k]) * inv_std[k] : 0.f;
  }
}

// The reduction grid's blocks: the most chunks a batch of G graphs of V
// rows can own (chunks_of(V) for one graph).
int64_t max_chunks(int V, int G) {
  return (V + kRowsPerChunk - 1) / kRowsPerChunk + (G > 1 ? G : 0);
}

// Floats of scratch for G graphs of [V, C]: the partials, mean and inv_std
// per graph, then 2 (G + 1) run and chunk starts (int32, the width of a
// float).
int64_t scratch_floats(int V, int C, int G) {
  return max_chunks(V, G) * C + 2 * static_cast<int64_t>(G) * C +
         2 * (static_cast<int64_t>(G) + 1);
}

int launch(const float* x, const int* num_valid, const int* graph_id, int G,
           float* out, float* scratch, int V, int C, float eps, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (G < 1 || G > kMaxGraphs) return cudaErrorInvalidValue;
  if (V <= 0 || C <= 0) return cudaSuccess;
  const int64_t chunks = max_chunks(V, G);
  float* partial = scratch;
  float* mean = scratch + chunks * C;
  float* inv_std = mean + static_cast<int64_t>(G) * C;
  int* start = nullptr;
  int* cstart = nullptr;
  const int threads = 256;
  if (graph_id) {
    start = reinterpret_cast<int*>(inv_std + static_cast<int64_t>(G) * C);
    cstart = start + G + 1;
    const int blocks = min((V + threads - 1) / threads, 4096);
    run_starts<<<blocks, threads, 0, stream>>>(graph_id, V, G, start);
    chunk_starts<<<1, 1, 0, stream>>>(num_valid, start, V, G, cstart);
  }

  const dim3 red_block(kCols, kLanes);
  const dim3 red_grid(static_cast<unsigned>(chunks), (C + kCols - 1) / kCols);
  const int fin_threads = 128;
  const dim3 fin_grid((C + fin_threads - 1) / fin_threads, G);

  column_partials<<<red_grid, red_block, 0, stream>>>(
      x, num_valid, start, cstart, G, nullptr, partial, V, C);
  finalize<<<fin_grid, fin_threads, 0, stream>>>(
      partial, num_valid, start, cstart, V, C, eps, false, mean);
  column_partials<<<red_grid, red_block, 0, stream>>>(
      x, num_valid, start, cstart, G, mean, partial, V, C);
  finalize<<<fin_grid, fin_threads, 0, stream>>>(
      partial, num_valid, start, cstart, V, C, eps, true, inv_std);
  const int64_t total = static_cast<int64_t>(V) * C;
  // grid-stride loop: cap the grid, each thread takes several elements
  const int64_t needed = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(needed < (1 << 20) ? needed : (1 << 20));
  normalize_rows<<<blocks, threads, 0, stream>>>(x, num_valid, graph_id, G,
                                                 mean, inv_std, out, V, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of scratch memory the launchers below need for G graphs of [V, C]
// (G = 1 for masked_instance_norm_f32).
extern "C" int64_t masked_instance_norm_f32_scratch_floats(int V, int C,
                                                           int G) {
  return scratch_floats(V, C, G);
}

// One graph. x, out: [V, C] f32; num_valid: one int32 in device memory;
// scratch: masked_instance_norm_f32_scratch_floats(V, C, 1) floats.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int masked_instance_norm_f32(const float* x, const int* num_valid,
                                        float* out, float* scratch, int V,
                                        int C, float eps, int device,
                                        cudaStream_t stream) {
  return launch(x, num_valid, nullptr, 1, out, scratch, V, C, eps, device,
                stream);
}

// G graphs. As masked_instance_norm_f32, with graph_id: [V] int32,
// non-decreasing, pad rows = G; scratch: ..._scratch_floats(V, C, G).
extern "C" int masked_instance_norm_multigraph_f32(
    const float* x, const int* num_valid, const int* graph_id, float* out,
    float* scratch, int V, int C, int G, float eps, int device,
    cudaStream_t stream) {
  return launch(x, num_valid, graph_id, G, out, scratch, V, C, eps, device,
                stream);
}
