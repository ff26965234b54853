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
// All three, f32 and bf16, are one row loop (rows_body below) behind three
// kernels: ell_fwd_rows (the forward), ell_dp_rows and ell_dq_rows. The
// forward can also divide by the edge set's total degree, the EdgeConv mean
// (ops/message_passing.py:edge_conv_aggregate): given `mean_deg`, a row's
// f32 sums are rounded to the row type, times 1 / max(degree, 1) in f32 and
// rounded again, the roundings of the torch ops it replaces, in their
// order. The mean's backward scales g once (mean_rows) before dp and dq.
// The arithmetic is slot_loop.cuh's: p + q rounded to the row type, relu and
// step in f32 (relu as x < 0 ? 0 : x), f32 sums in slot order from +0.0
// with one acc + g * step(z) a live slot (g is never factored out, so an
// inf or NaN g gives NaN as the plain version's inf * 0 does), dead slots
// skipped, one rounding at the end. Every result is bit for bit the plain
// version's (ops/ell.py).
//
// Bound: bytes. Each output element costs 3 flops per live slot (add, max
// or compare, add) against one or two gathered elements, far below the
// card's ratio of flops to bytes. The unavoidable traffic is the degree,
// the live slots of the index table and the output once each, the own
// rows once (p for the forward; p and g for dp, one row more than the
// forward; q for dq) and each gathered row once (q for the forward and
// dp; g and p of each receiver for dq, twice the forward's gathered
// bytes); gathered rows that several rows share are served from L2.
//
// Design. A row's channels are cut into 16-byte chunks (4 f32 or 8 bf16).
// A group of `lanes` lanes (a power of two up to 32, so a warp holds
// 32 / lanes groups) owns one row, or one of `groups` parts of a row, each
// lane `chunks` chunks. A lane keeps its own operands' chunks (and its f32
// sums) in registers through the whole slot loop: the channels are never
// looped around it, so each row's slot indices and degree are read once.
// The group's lanes load the row's indices coalesced, `lanes` slots at a
// time (the first ones beside the degree and the own rows, so the gathers
// wait on one load, not two; later ones only where live), and broadcast
// them in slot order by shuffles; the 16-byte ld.global.nc gathers of
// loads-in-flight / (chunks x gathered rows a slot) slots are issued
// before any is summed, and the sums run in slot order. The gradients
// hold a row's operands in 1 chunk a lane, a wide row split into more
// groups (ops/ell.py:ell_plan): dp holds g beside p, and dq gathers two
// rows a slot (g and p of the receiver), so the same budget of loads covers
// half as many slots; more groups keep more warps, and so more gathers, in
// flight within the registers of 4 blocks an SM. A row's slots are summed
// in order by one group, so a sender with many receivers (the reverse
// tables are skewed: 64 slots against about 6 live on most rows) is a
// chain of dependent gathers that more warps do not shorten.
// Rows whose bytes are a multiple of 16 on 16-byte-aligned operands take
// 16-byte loads and stores (kVec); any other shape or view takes the same
// loop with element loads and stores (the chunks of a row's last 16 bytes
// stop at H). The layout is worked out in Python (ops/ell.py:ell_plan); the
// launcher checks it and launches exactly that plan. The gathered rows
// come from L2 several times over (each sender feeds about 6 receivers), so
// a call likely approaches the L2's rate rather than device memory's
// (inferred from where every variant of sweep_k1.py levels off; no
// hardware counter was read).
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
// (sweep_k1.py), for the forward and for the gradients (dp and dq, which
// hold 1 chunk a lane in their plans: at 4 blocks they need no spill).
constexpr int kLoadsInFlight = 4;
constexpr int kMinBlocks = 3;
constexpr int kGradLoadsInFlight = 4;
constexpr int kGradMinBlocks = 4;

// The three sums of the row loop: the forward and dp on the receiver side
// (gather q through nbr), dq on the sender side (gather g and p through
// rev).
enum Kind { kSum = 0, kDp = 1, kDq = 2 };
constexpr int kKinds = 3;

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

// The row loop of one group: its row (or part of one) of the sum of kind
// kKind. own: the row's own operand (p for the forward and dp, q for dq);
// own_g: dp's own g (else unused); rows_a, rows_b: the gathered rows (q for
// the forward and dp; g and p for dq, rows_b unused otherwise); idx, count:
// nbr and deg, or rev and deg_out; mean_deg: the forward's total degrees,
// null for the sum itself (unused by dp and dq).
template <typename T, int kKind, bool kVec, int kChunks>
__device__ __forceinline__ void rows_body(
    const T* __restrict__ own, const T* __restrict__ own_g,
    const T* __restrict__ rows_a, const T* __restrict__ rows_b,
    const int* __restrict__ idx, const float* __restrict__ count,
    const float* __restrict__ mean_deg, T* __restrict__ out, int V, int H,
    int D, int lanes, int groups) {
  using Vec = stinet::Vec16<T>;
  constexpr int kN = Vec::kN;
  constexpr int kLoads = kKind == kSum ? kLoadsInFlight : kGradLoadsInFlight;
  constexpr int kPerSlot = (kKind == kDq ? 2 : 1) * kChunks;
  constexpr int kAhead = kPerSlot >= kLoads ? 1 : kLoads / kPerSlot;
  constexpr int kOwnG = kKind == kDp ? kChunks : 1;   // dp's g chunks
  constexpr int kRowsB = kKind == kDq ? kChunks : 1;  // dq's gathered p
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
  float xv[kChunks][kN], acc[kChunks][kN];
  uint4 gown[kOwnG];  // dp: the row's own g, unpacked where it is used
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = (part * kChunks + c) * lanes + lane;
    has[c] = live_row && j < row_chunks;
    col[c] = j * kN;
    const uint4 u = has[c] ? load_chunk<T, kVec>(own + base + col[c],
                                                 H - col[c])
                           : make_uint4(0u, 0u, 0u, 0u);
    Vec::unpack(u, xv[c]);
    if constexpr (kKind == kDp) {
      gown[c] = has[c] ? load_chunk<T, kVec>(own_g + base + col[c],
                                             H - col[c])
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[c][i] = 0.f;
  }

  // The row's first `lanes` slot indices, one a lane, are read beside its
  // degree and own rows, not after them (a dead slot's index is read,
  // never used); later ones only where live. Every lane of the group reads
  // the same degree (one transaction); the warp loops to its longest row
  // so that its shuffles stay converged.
  const int* irow = idx + r64 * D;
  int mine = live_row && lane < D ? __ldg(irow + lane) : 0;
  const int dv = live_row ? min(static_cast<int>(count[row]), D) : 0;
  // the forward's mean: the row's scale, its degree read beside the count
  const bool mean = kKind == kSum && mean_deg != nullptr;
  const float scale =
      mean && live_row ? stinet::mean_scale<T>(__ldg(mean_deg + row)) : 1.f;
  const int dmax = __reduce_max_sync(0xffffffffu, dv);
  for (int d0 = 0; d0 < dmax; d0 += lanes) {
    if (d0 > 0) mine = d0 + lane < dv ? __ldg(irow + d0 + lane) : 0;
    const int span = min(lanes, dmax - d0);
    for (int k0 = 0; k0 < span; k0 += kAhead) {
      bool live[kAhead];
      uint4 ga[kAhead][kChunks], gb[kAhead][kRowsB];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int r = k0 + k;
        const int s = __shfl_sync(0xffffffffu, mine, r, lanes);
        live[k] = r < span && d0 + r < dv;
        const int64_t srow = static_cast<int64_t>(s) * H;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const bool on = live[k] && has[c];
          ga[k][c] = on ? load_chunk<T, kVec>(rows_a + srow + col[c],
                                              H - col[c])
                        : make_uint4(0u, 0u, 0u, 0u);
          if constexpr (kKind == kDq) {
            gb[k][c] = on ? load_chunk<T, kVec>(rows_b + srow + col[c],
                                                H - col[c])
                          : make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (!live[k]) break;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float a[kN];
          Vec::unpack(ga[k][c], a);
          if constexpr (kKind == kSum) {
#pragma unroll
            for (int i = 0; i < kN; ++i) {
              const float z = stinet::Elem<T>::add(xv[c][i], a[i]);
              acc[c][i] = acc[c][i] + stinet::relu(z);
            }
          } else if constexpr (kKind == kDp) {
            float gv[kN];
            Vec::unpack(gown[c], gv);
#pragma unroll
            for (int i = 0; i < kN; ++i) {
              const float z = stinet::Elem<T>::add(xv[c][i], a[i]);
              acc[c][i] = acc[c][i] + gv[i] * stinet::step(z);
            }
          } else {
            float b[kN];  // p of the receiver; a is its g
            Vec::unpack(gb[k][c], b);
#pragma unroll
            for (int i = 0; i < kN; ++i) {
              const float z = stinet::Elem<T>::add(b[i], xv[c][i]);
              acc[c][i] = acc[c][i] + a[i] * stinet::step(z);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!has[c]) continue;
    if (mean) stinet::scale_rounded<T, kN>(acc[c], scale);
    stinet::store16(out + base + col[c], acc[c], H - col[c], kVec);
  }
}

// The three kernels, one name each (a profiler tells them apart), with one
// argument list: rows_body's.
#define STINET_ELL_ROWS_ARGS                                              \
  const T *__restrict__ own, const T *__restrict__ own_g,                 \
      const T *__restrict__ rows_a, const T *__restrict__ rows_b,         \
      const int *__restrict__ idx, const float *__restrict__ count,       \
      const float *__restrict__ mean_deg, T *__restrict__ out, int V,     \
      int H, int D, int lanes, int groups
#define STINET_ELL_ROWS_CALL \
  own, own_g, rows_a, rows_b, idx, count, mean_deg, out, V, H, D, lanes, \
      groups

template <typename T, bool kVec, int kChunks>
__global__ void __launch_bounds__(stinet::kThreads, kMinBlocks)
    ell_fwd_rows(STINET_ELL_ROWS_ARGS) {
  rows_body<T, kSum, kVec, kChunks>(STINET_ELL_ROWS_CALL);
}

template <typename T, bool kVec, int kChunks>
__global__ void __launch_bounds__(stinet::kThreads, kGradMinBlocks)
    ell_dp_rows(STINET_ELL_ROWS_ARGS) {
  rows_body<T, kDp, kVec, kChunks>(STINET_ELL_ROWS_CALL);
}

template <typename T, bool kVec, int kChunks>
__global__ void __launch_bounds__(stinet::kThreads, kGradMinBlocks)
    ell_dq_rows(STINET_ELL_ROWS_ARGS) {
  rows_body<T, kDq, kVec, kChunks>(STINET_ELL_ROWS_CALL);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
using RowsKernel = void (*)(const T*, const T*, const T*, const T*,
                            const int*, const float*, const float*, T*, int,
                            int, int, int, int);

template <typename T, int kKind, bool kVec, int kChunks>
RowsKernel<T> kernel_of() {
  if constexpr (kKind == kSum) {
    return ell_fwd_rows<T, kVec, kChunks>;
  } else if constexpr (kKind == kDp) {
    return ell_dp_rows<T, kVec, kChunks>;
  } else {
    return ell_dq_rows<T, kVec, kChunks>;
  }
}

template <typename T, int kKind>
RowsKernel<T> rows_kernel(bool vector, int chunks) {
  static_assert(kMaxChunks == 2, "one kernel a chunk count");
  if (vector) {
    return chunks == 1 ? kernel_of<T, kKind, true, 1>()
                       : kernel_of<T, kKind, true, 2>();
  }
  return chunks == 1 ? kernel_of<T, kKind, false, 1>()
                     : kernel_of<T, kKind, false, 2>();
}

// The last launch of each kind: lanes, chunks, groups, blocks, threads,
// vector.
constexpr int kRecord = 6;
int g_last[kKinds][kRecord];

// Launch the sum of kind kKind with the plan of ops/ell.py:ell_plan (lanes
// a group, chunks a lane, groups a row, blocks, 16-byte loads or not), the
// forward's mean over `mean_deg` where that is not null. A
// plan that does not describe the shapes (a lane count that is not a power
// of two up to 32, chunks outside [1, kMaxChunks], groups that leave a
// chunk uncovered or one empty, a grid of another size, 16-byte loads on
// rows or pointers that do not allow them) is refused with
// cudaErrorInvalidValue.
template <typename T, int kKind>
int launch_rows(const void* own, const void* own_g, const void* rows_a,
                const void* rows_b, const int* idx, const float* count,
                const float* mean_deg, void* out, int V, int H, int D,
                int lanes, int chunks, int groups, int blocks, int vector,
                int device, cudaStream_t stream) {
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
  const void* operands[] = {own, own_g, rows_a, rows_b, out};
  bool all_aligned = true;
  for (const void* ptr : operands) {
    all_aligned = all_aligned && (ptr == nullptr || aligned16(ptr));
  }
  if (vector != 0 && (vector != 1 || row_bytes % 16 != 0 || !all_aligned)) {
    return cudaErrorInvalidValue;
  }
  const int record[kRecord] = {lanes,  chunks, groups, blocks,
                               stinet::kThreads, vector};
  for (int i = 0; i < kRecord; ++i) g_last[kKind][i] = record[i];
  const RowsKernel<T> kernel = rows_kernel<T, kKind>(vector != 0, chunks);
  kernel<<<blocks, stinet::kThreads, 0, stream>>>(
      static_cast<const T*>(own), static_cast<const T*>(own_g),
      static_cast<const T*>(rows_a), static_cast<const T*>(rows_b), idx,
      count, mean_deg, static_cast<T*>(out), V, H, D, lanes, groups);
  return cudaGetLastError();
}

// out[v, :] = T(f32(x[v, :]) * mean_scale(mean_deg[v])): the mean's
// backward, what the autograd of its torch tail computes (g to f32, times
// the scale, back to T), in one pass of 16 bytes a thread (2 + 2 bytes an
// element in bf16 against the tail's 20). Bound: bytes.
template <typename T, bool kVec>
__global__ void __launch_bounds__(stinet::kThreads)
    mean_rows(const T* __restrict__ x, const float* __restrict__ mean_deg,
              T* __restrict__ out, int V, int H) {
  constexpr int kN = stinet::Vec16<T>::kN;
  const int row_chunks = (H + kN - 1) / kN;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * stinet::kThreads +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(V) * row_chunks) return;
  const int row = static_cast<int>(i / row_chunks);
  const int col = static_cast<int>(i - static_cast<int64_t>(row) * row_chunks)
                  * kN;
  const int64_t at = static_cast<int64_t>(row) * H + col;
  float f[kN];
  stinet::Vec16<T>::unpack(load_chunk<T, kVec>(x + at, H - col), f);
  stinet::scale_rounded<T, kN>(f,
                               stinet::mean_scale<T>(__ldg(mean_deg + row)));
  stinet::store16(out + at, f, H - col, kVec);
}

template <typename T>
int launch_mean_rows(const void* x, const float* mean_deg, void* out, int V,
                     int H, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (V <= 0 || H <= 0) return cudaSuccess;
  constexpr int kN = stinet::Vec16<T>::kN;
  const int64_t chunks = static_cast<int64_t>(V) * ((H + kN - 1) / kN);
  const int64_t blocks = (chunks + stinet::kThreads - 1) / stinet::kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool vec = (static_cast<int64_t>(H) * sizeof(T)) % 16 == 0 &&
                   aligned16(x) && aligned16(out);
  const auto kernel = vec ? mean_rows<T, true> : mean_rows<T, false>;
  kernel<<<static_cast<unsigned>(blocks), stinet::kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean_deg, static_cast<T*>(out), V, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..5] = the last launch of `kind` (0 the forward, 1 dp, 2 dq): lanes,
// chunks, groups, blocks, threads and whether it took 16-byte loads.
extern "C" void ell_last_launch(int kind, int* out) {
  for (int i = 0; i < kRecord; ++i) {
    out[i] = kind >= 0 && kind < kKinds ? g_last[kind][i] : 0;
  }
}

// Every launcher below launches on `stream` with the plan of
// ops/ell.py:ell_plan (lanes, chunks, groups, blocks, vector) and returns
// the launch error.

// p, q, out: [V, H] f32 (q may have any row count the indices stay inside);
// nbr: [V, D] int32 with every live slot a valid row of q; deg: [V] f32;
// mean_deg: null (out is the sum) or [V] f32 total degrees (out is the
// mean over them).
extern "C" int ell_edge_conv_sum_fwd_f32(const void* p, const void* q,
                                         const int* nbr, const float* deg,
                                         const float* mean_deg, void* out,
                                         int V, int H, int D, int lanes,
                                         int chunks, int groups, int blocks,
                                         int vector, int device,
                                         cudaStream_t stream) {
  return launch_rows<float, kSum>(p, nullptr, q, nullptr, nbr, deg, mean_deg,
                                  out, V, H, D, lanes, chunks, groups, blocks,
                                  vector, device, stream);
}

// The same sum on bf16 rows: z = bf16(p + q) (round to nearest even),
// relu and accumulation in f32, output rounded to bf16 (the mean: the
// rounded sum times the scale in f32, rounded to bf16 again).
extern "C" int ell_edge_conv_sum_fwd_bf16(const void* p, const void* q,
                                          const int* nbr, const float* deg,
                                          const float* mean_deg, void* out,
                                          int V, int H, int D, int lanes,
                                          int chunks, int groups, int blocks,
                                          int vector, int device,
                                          cudaStream_t stream) {
  return launch_rows<bf16, kSum>(p, nullptr, q, nullptr, nbr, deg, mean_deg,
                                 out, V, H, D, lanes, chunks, groups, blocks,
                                 vector, device, stream);
}

// out = x * 1 / max(mean_deg, 1) row by row, rounded as the torch tail
// rounds (mean_rows); x, out: [V, H] of one dtype, mean_deg: [V] f32.
extern "C" int ell_mean_rows_f32(const void* x, const float* mean_deg,
                                 void* out, int V, int H, int device,
                                 cudaStream_t stream) {
  return launch_mean_rows<float>(x, mean_deg, out, V, H, device, stream);
}

extern "C" int ell_mean_rows_bf16(const void* x, const float* mean_deg,
                                  void* out, int V, int H, int device,
                                  cudaStream_t stream) {
  return launch_mean_rows<bf16>(x, mean_deg, out, V, H, device, stream);
}

// dp = sum_d g * step(p + q[nbr]); p, q, g, out: [V, H] of one dtype.
extern "C" int ell_edge_conv_dp_f32(const void* p, const void* q,
                                    const int* nbr, const float* deg,
                                    const void* g, void* out, int V, int H,
                                    int D, int lanes, int chunks, int groups,
                                    int blocks, int vector, int device,
                                    cudaStream_t stream) {
  return launch_rows<float, kDp>(p, g, q, nullptr, nbr, deg, nullptr, out, V,
                                 H, D, lanes, chunks, groups, blocks, vector,
                                 device, stream);
}

extern "C" int ell_edge_conv_dp_bf16(const void* p, const void* q,
                                     const int* nbr, const float* deg,
                                     const void* g, void* out, int V, int H,
                                     int D, int lanes, int chunks, int groups,
                                     int blocks, int vector, int device,
                                     cudaStream_t stream) {
  return launch_rows<bf16, kDp>(p, g, q, nullptr, nbr, deg, nullptr, out, V,
                                H, D, lanes, chunks, groups, blocks, vector,
                                device, stream);
}

// dq[s] = sum_j g[rev[s, j]] * step(p[rev[s, j]] + q[s]); rev: [V, D].
extern "C" int ell_edge_conv_dq_f32(const void* q, const void* g,
                                    const void* p, const int* rev,
                                    const float* deg_out, void* out, int V,
                                    int H, int D, int lanes, int chunks,
                                    int groups, int blocks, int vector,
                                    int device, cudaStream_t stream) {
  return launch_rows<float, kDq>(q, nullptr, g, p, rev, deg_out, nullptr, out,
                                 V, H, D, lanes, chunks, groups, blocks, vector,
                                 device, stream);
}

extern "C" int ell_edge_conv_dq_bf16(const void* q, const void* g,
                                     const void* p, const int* rev,
                                     const float* deg_out, void* out, int V,
                                     int H, int D, int lanes, int chunks,
                                     int groups, int blocks, int vector,
                                     int device, cudaStream_t stream) {
  return launch_rows<bf16, kDq>(q, nullptr, g, p, rev, deg_out, nullptr, out,
                                V, H, D, lanes, chunks, groups, blocks, vector,
                                device, stream);
}
