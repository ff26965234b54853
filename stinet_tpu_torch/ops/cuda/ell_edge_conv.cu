// EdgeConv message sum over ELL neighbour tables, and its backward.
//
//   out[v, :] = sum_{d < min(deg[v], D)} relu(p[v, :] + q[nbr[v, d], :])
//
// Replaces the TPU kernel K1, pallas_ell_edge_conv_sum
// (stinet_tpu/ops/pallas/gather_pipeline.py:102, kernel :38-99), which
// computes the same sum as the XLA path stinet_tpu/ops/ell.py:66-93, and
// that path's backward (stinet_tpu/ops/ell.py:100-161, XLA in JAX):
//
//   dp[v] = sum_{d < deg[v]} g[v] * step(p[v] + q[nbr[v, d]])
//   dq[s] = sum_{j < deg_out[s]} g[r] * step(p[r] + q[s]),  r = rev[s, j]
//
// The forward, f32 and bf16, is ell_fwd_rows below; dp and dq are the slot
// loops of slot_loop.cuh with rows read from device memory. The arithmetic
// is slot_loop.cuh's: p + q rounded to the row type, relu in f32 as
// x < 0 ? 0 : x, f32 sums in slot order from +0.0, dead slots skipped, one
// rounding at the end; no multiply, so no FMA contraction. Every result is
// bit for bit the plain version's (ops/ell.py).
//
// Bound: bytes. Each output element costs 3 flops per live slot (add, max,
// add) against one gathered element, far below the card's ratio of flops
// to bytes. The unavoidable traffic is p, q, nbr, deg and out once each;
// gathered q rows that several receivers share are served from L2.
//
// Design of the forward. A row's channels are cut into 16-byte chunks (4
// f32 or 8 bf16). A group of `lanes` lanes (a power of two up to 32, so a
// warp holds 32 / lanes groups) owns one row, or one of `groups` parts of a
// row wider than 32 lanes x kMaxChunks chunks, each lane `chunks` chunks. A
// lane keeps its p chunks and f32 sums in registers through the whole slot
// loop: the channels are never looped around it, so each row's slot
// indices and degree are read once. The group's lanes load the row's
// indices coalesced, `lanes` slots at a time (the first ones beside the
// degree and p, so the gathers wait on one load, not two), and broadcast
// them in slot order by shuffles; the 16-byte ld.global.nc gathers of
// kLoadsInFlight / chunks slots (all chunks) are issued before any is
// summed, and the sums run in slot order. Rows whose bytes are a multiple
// of 16 on 16-byte-aligned p, q and out take 16-byte loads and stores
// (kVec); any other shape or view takes the same loop with element loads
// and stores (the chunks of a row's last 16 bytes stop at H). The layout is
// worked out in Python (ops/ell.py:ell_plan); the launcher checks it and
// launches exactly that plan. The gathered rows come from L2 several times
// over (each sender feeds about 6 receivers), so a call likely approaches
// the L2's rate rather than device memory's (inferred from where every
// variant of sweep_k1.py levels off; no hardware counter was read).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "slot_loop.cuh"

namespace {

using bf16 = __nv_bfloat16;

// 16-byte chunks a lane holds at most (a wider row splits into groups: on
// the flagship's f32 H=512 rows 2 groups of 2 chunks ran faster than one
// of 4, whose registers left 2 blocks an SM).
constexpr int kMaxChunks = 2;
// Gathered chunks a lane issues at once, and resident blocks an SM that
// registers are budgeted for: the fastest of loads in flight 4, 8, 16 by
// budgets of none, 3 and 4 blocks on the flagship's own tables
// (sweep_k1.py).
constexpr int kLoadsInFlight = 4;
constexpr int kMinBlocks = 3;

// One 16-byte chunk of a row at `ptr`, of which the first `left` elements
// lie inside the row: one ld.global.nc.v4 (kVec), else element loads with
// the elements past the row left 0.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_chunk(const T* ptr, int left) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(ptr));
  } else {
    constexpr int kN = stinet::Vec16<T>::kN;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (i >= left) break;
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(__ldg(reinterpret_cast<const float*>(ptr) + i));
      } else {
        const uint32_t bits =
            __ldg(reinterpret_cast<const unsigned short*>(ptr) + i);
        w[i / 2] |= bits << (16 * (i % 2));
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, bool kVec, int kChunks>
__global__ void __launch_bounds__(stinet::kThreads, kMinBlocks)
    ell_fwd_rows(const T* __restrict__ p, const T* __restrict__ q,
                 const int* __restrict__ nbr, const float* __restrict__ deg,
                 T* __restrict__ out, int V, int H, int D, int lanes,
                 int groups) {
  using Vec = stinet::Vec16<T>;
  constexpr int kN = Vec::kN;
  constexpr int kAhead =
      kChunks >= kLoadsInFlight ? 1 : kLoadsInFlight / kChunks;
  const int t = threadIdx.x;
  const int lane = t & (lanes - 1);
  // group -> (row, part): ops/ell.py:EllPlan.chunk_of
  const int group = blockIdx.x * (stinet::kThreads / lanes) + t / lanes;
  const int row = group / groups;
  const int part = group - row * groups;
  const bool live_row = row < V;
  const int row_chunks = (H * static_cast<int>(sizeof(T)) + 15) / 16;
  const int64_t r64 = live_row ? row : 0;  // tail lanes read row 0
  const int64_t base = r64 * H;

  int col[kChunks];   // first channel of each of this lane's chunks
  bool has[kChunks];
  float pv[kChunks][kN], acc[kChunks][kN];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = (part * kChunks + c) * lanes + lane;
    has[c] = live_row && j < row_chunks;
    col[c] = j * kN;
    const uint4 u = has[c] ? load_chunk<T, kVec>(p + base + col[c],
                                                 H - col[c])
                           : make_uint4(0u, 0u, 0u, 0u);
    Vec::unpack(u, pv[c]);
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[c][i] = 0.f;
  }

  // The row's first `lanes` slot indices, one a lane, are read beside its
  // degree and p, not after them (a dead slot's index is read, never
  // used); later ones only where live. Every lane of the group reads the
  // same degree (one transaction); the warp loops to its longest row so
  // that its shuffles stay converged.
  const int* irow = nbr + r64 * D;
  int mine = live_row && lane < D ? __ldg(irow + lane) : 0;
  const int dv = live_row ? min(static_cast<int>(deg[row]), D) : 0;
  const int dmax = __reduce_max_sync(0xffffffffu, dv);
  for (int d0 = 0; d0 < dmax; d0 += lanes) {
    if (d0 > 0) mine = d0 + lane < dv ? __ldg(irow + d0 + lane) : 0;
    const int span = min(lanes, dmax - d0);
    for (int k0 = 0; k0 < span; k0 += kAhead) {
      bool live[kAhead];
      uint4 gq[kAhead][kChunks];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int r = k0 + k;
        const int s = __shfl_sync(0xffffffffu, mine, r, lanes);
        live[k] = r < span && d0 + r < dv;
        const T* qrow = q + static_cast<int64_t>(s) * H;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          gq[k][c] = live[k] && has[c]
                         ? load_chunk<T, kVec>(qrow + col[c], H - col[c])
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (!live[k]) break;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float qv[kN];
          Vec::unpack(gq[k][c], qv);
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            const float z = stinet::Elem<T>::add(pv[c][i], qv[i]);
            acc[c][i] = acc[c][i] + stinet::relu(z);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (has[c]) stinet::store16(out + base + col[c], acc[c], H - col[c], kVec);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
using RowsKernel = void (*)(const T*, const T*, const int*, const float*, T*,
                            int, int, int, int, int);

template <typename T, bool kVec>
RowsKernel<T> rows_kernel(int chunks) {
  static_assert(kMaxChunks == 2, "one kernel a chunk count");
  return chunks == 1 ? ell_fwd_rows<T, kVec, 1> : ell_fwd_rows<T, kVec, 2>;
}

// The last forward launch: lanes, chunks, groups, blocks, threads, vector.
constexpr int kRecord = 6;
int g_last_fwd[kRecord];

// Launch the forward with the plan of ops/ell.py:ell_plan (lanes a group,
// chunks a lane, groups a row, blocks, 16-byte loads or not). A plan that
// does not describe the shapes (a lane count that is not a power of two up
// to 32, chunks outside [1, kMaxChunks], groups that leave a chunk uncovered
// or one empty, a grid of another size, 16-byte loads on rows or pointers
// that do not allow them) is refused with cudaErrorInvalidValue.
template <typename T>
int launch_fwd(const void* p, const void* q, const int* nbr, const float* deg,
               void* out, int V, int H, int D, int lanes, int chunks,
               int groups, int blocks, int vector, int device,
               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (V <= 0 || H <= 0) return cudaSuccess;
  const int64_t row_bytes = static_cast<int64_t>(H) * sizeof(T);
  const int64_t row_chunks = (row_bytes + 15) / 16;
  const int64_t per_group = static_cast<int64_t>(lanes) * chunks;
  const int64_t all_groups = static_cast<int64_t>(V) * groups;
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (!pow2 || chunks < 1 || chunks > kMaxChunks || groups < 1 ||
      groups * per_group < row_chunks ||
      (groups - 1) * per_group >= row_chunks || all_groups > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  const int per_block = stinet::kThreads / lanes;
  if (blocks != (all_groups + per_block - 1) / per_block) {
    return cudaErrorInvalidValue;
  }
  if (vector != 0 && (vector != 1 || row_bytes % 16 != 0 || !aligned16(p) ||
                      !aligned16(q) || !aligned16(out))) {
    return cudaErrorInvalidValue;
  }
  const int record[kRecord] = {lanes,  chunks, groups, blocks,
                               stinet::kThreads, vector};
  for (int i = 0; i < kRecord; ++i) g_last_fwd[i] = record[i];
  const RowsKernel<T> kernel = vector ? rows_kernel<T, true>(chunks)
                                      : rows_kernel<T, false>(chunks);
  kernel<<<blocks, stinet::kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(q), nbr, deg,
      static_cast<T*>(out), V, H, D, lanes, groups);
  return cudaGetLastError();
}

// Slot loops of the gradients on rows read from device memory
// (slot_loop.cuh). One block covers kRows rows of one 64-channel slice: a
// warp a row, two channels a lane. Bound: bytes, as the forward above; the
// nbr / rev indices are warp-uniform loads and the gathered rows coalesced
// 2 * 32-element reads.
constexpr int kSlice = 64;
constexpr int kRows = stinet::kThreads / (kSlice / 2);

template <typename T>
__global__ void __launch_bounds__(stinet::kThreads)
    ell_receiver(const T* __restrict__ p, const T* __restrict__ g,
                 const T* __restrict__ q, const int* __restrict__ nbr,
                 const float* __restrict__ deg, T* __restrict__ out, int V,
                 int H, int D) {
  const int r0 = blockIdx.x * kRows;
  const stinet::GlobalRows<T> rows{q, H};
  stinet::receiver_rows<T>(p, g, rows, nbr, deg, out, r0,
                           min(r0 + kRows, V), H, D, blockIdx.y * kSlice,
                           kSlice);
}

template <typename T>
__global__ void __launch_bounds__(stinet::kThreads)
    ell_sender(const T* __restrict__ q, const T* __restrict__ g,
               const T* __restrict__ p, const int* __restrict__ rev,
               const float* __restrict__ deg_out, T* __restrict__ out, int V,
               int H, int D) {
  const int s0 = blockIdx.x * kRows;
  const stinet::GlobalRows<T> g_rows{g, H}, p_rows{p, H};
  stinet::sender_rows<T>(q, g_rows, p_rows, rev, deg_out, out, s0,
                         min(s0 + kRows, V), H, D, blockIdx.y * kSlice,
                         kSlice);
}

dim3 slice_grid(int V, int H) {
  return dim3((V + kRows - 1) / kRows, (H + kSlice - 1) / kSlice);
}

template <typename T>
int launch_dp(const void* p, const void* g, const void* q, const int* nbr,
              const float* deg, void* out, int V, int H, int D, int device,
              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (V <= 0 || H <= 0) return cudaSuccess;
  ell_receiver<T><<<slice_grid(V, H), stinet::kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g),
      static_cast<const T*>(q), nbr, deg, static_cast<T*>(out), V, H, D);
  return cudaGetLastError();
}

template <typename T>
int launch_sender(const void* q, const void* g, const void* p, const int* rev,
                  const float* deg_out, void* out, int V, int H, int D,
                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (V <= 0 || H <= 0) return cudaSuccess;
  ell_sender<T><<<slice_grid(V, H), stinet::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g),
      static_cast<const T*>(p), rev, deg_out, static_cast<T*>(out), V, H, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..5] = the last forward launch's lanes, chunks, groups, blocks,
// threads and whether it took 16-byte loads.
extern "C" void ell_last_launch(int* out) {
  for (int i = 0; i < kRecord; ++i) out[i] = g_last_fwd[i];
}

// p, q, out: [V, H] f32 (q may have any row count the indices stay inside);
// nbr: [V, D] int32 with every live slot a valid row of q; deg: [V] f32;
// lanes, chunks, groups, blocks and vector: ops/ell.py:ell_plan's. Launches
// on `stream` and returns the launch error.
extern "C" int ell_edge_conv_sum_fwd_f32(const void* p, const void* q,
                                         const int* nbr, const float* deg,
                                         void* out, int V, int H, int D,
                                         int lanes, int chunks, int groups,
                                         int blocks, int vector, int device,
                                         cudaStream_t stream) {
  return launch_fwd<float>(p, q, nbr, deg, out, V, H, D, lanes, chunks,
                           groups, blocks, vector, device, stream);
}

// The same sum on bf16 rows: z = bf16(p + q) (round to nearest even),
// relu and accumulation in f32, output rounded to bf16.
extern "C" int ell_edge_conv_sum_fwd_bf16(const void* p, const void* q,
                                          const int* nbr, const float* deg,
                                          void* out, int V, int H, int D,
                                          int lanes, int chunks, int groups,
                                          int blocks, int vector, int device,
                                          cudaStream_t stream) {
  return launch_fwd<bf16>(p, q, nbr, deg, out, V, H, D, lanes, chunks,
                          groups, blocks, vector, device, stream);
}

// dp = sum_d g * step(p + q[nbr]); p, q, g, out: [V, H] of one dtype.
extern "C" int ell_edge_conv_dp_f32(const void* p, const void* q,
                                    const int* nbr, const float* deg,
                                    const void* g, void* out, int V, int H,
                                    int D, int device, cudaStream_t stream) {
  return launch_dp<float>(p, g, q, nbr, deg, out, V, H, D, device, stream);
}

extern "C" int ell_edge_conv_dp_bf16(const void* p, const void* q,
                                     const int* nbr, const float* deg,
                                     const void* g, void* out, int V, int H,
                                     int D, int device, cudaStream_t stream) {
  return launch_dp<bf16>(p, g, q, nbr, deg, out, V, H, D, device, stream);
}

// dq[s] = sum_j g[rev[s, j]] * step(p[rev[s, j]] + q[s]); rev: [V, D].
extern "C" int ell_edge_conv_dq_f32(const void* q, const void* g,
                                    const void* p, const int* rev,
                                    const float* deg_out, void* out, int V,
                                    int H, int D, int device,
                                    cudaStream_t stream) {
  return launch_sender<float>(q, g, p, rev, deg_out, out, V, H, D, device,
                              stream);
}

extern "C" int ell_edge_conv_dq_bf16(const void* q, const void* g,
                                     const void* p, const int* rev,
                                     const float* deg_out, void* out, int V,
                                     int H, int D, int device,
                                     cudaStream_t stream) {
  return launch_sender<__nv_bfloat16>(q, g, p, rev, deg_out, out, V, H, D,
                                      device, stream);
}
