// Windowed EdgeConv message sums on bandwidth-ordered graphs.
//
// Replaces the TPU kernels K3a, pallas_windowed_edge_conv_sum
// (stinet_tpu/ops/pallas/onehot_gather.py:252, _kernel :97-156), in its
// 'relu' (forward) and 'step' (dp factor) modes, K3b,
// pallas_windowed_edge_conv_sum_f32 (:291, the same _kernel with planes=3),
// and K3c, pallas_windowed_dq (:307, _kernel_dq :159-194):
//
//   relu: out[v] = sum_{d < deg[v]} relu(T(p[v] + q[nbr[v, d]]))
//   step: out[v] = sum_{d < deg[v]} step(bf16(p[v] + q[nbr[v, d]]))
//   dq:   out[s] = sum_{j < deg_out[s]} g[r] * step(bf16(p[r] + q[s])),
//         r = rev[s, j]
//
// with f32 accumulation in slot order and an output of the row type T, the
// arithmetic of slot_loop.cuh (bit for bit the plain versions in
// ops/windowed.py). Two epilogues fold in the torch ops that followed the
// sums, in their roundings: relu with `mean_deg`, the EdgeConv mean
// (ops/message_passing.py:edge_conv_aggregate), each row's sums rounded to
// T, times 1 / max(degree, 1) in f32, rounded to T; step with `g`, the
// K3d backward's dp, out[v] = T(f32(g[v]) * f32(T(count))). Relu runs on
// bf16 rows (K3a) and on f32 rows (K3b); step and dq on bf16 rows. K3b is
// bit for bit the f32 K1 (ell_edge_conv.cu). The TPU split each f32 row
// into three bf16 planes because its one-hot MXU gather is exact only in
// bf16; the card copies the f32 rows themselves.
//
// Contract: every live slot of a tile [i*T, (i+1)*T) points into the tile's
// window [w0, w0 + W), w0 = clamp(i*T - halo, 0, V - W),
// W = min(T + 2*halo, V). A slot outside it traps; pad slots are tested
// against the degree before their index is used.
//
// Bound: bytes. nbr, deg, p (or q) and out once, and each gathered row
// once (g and p for dq); the arithmetic is a few f32 operations per gathered
// element.
//
// Design. The TPU streamed each tile's window into VMEM, double-buffered
// across its sequential grid steps. Here:
// - A block walks a strip of consecutive tiles of one channel slice (the
//   loop over tiles takes the place of the TPU's sequential grid
//   dimension), so the rows that neighbouring windows share are copied
//   once a strip instead of once a tile: a strip of L rows copies about
//   L + 2*halo rows of each staged array, not (L/T)*(T + 2*halo).
// - The rows stream through a ring in shared memory, in stages of `sub`
//   rows. One producer warp keeps it full: a stage is one 2D TMA copy
//   (cp.async.bulk.tensor) of [sub rows x cs channels] per staged array,
//   whose "full" mbarrier counts the bytes in; channels past H arrive as
//   TMA's zero fill. The ring holds a tile's whole clamped window plus one
//   tile of rows ahead, so the next tile's new rows land while this tile
//   computes; 8 consumer warps wait on "full" for the stages of the tile's
//   window and arrive on "empty" for the stages the next window drops. No
//   warp waits at a block-wide barrier, and the copy costs the consumer
//   threads no instruction or register.
// - The block's own rows come the same way, one chunk ahead, through a
//   ring of buffers: x (p, or q for dq) by one TMA box, the index rows and
//   counts by 4-byte cp.async tracked by the buffer's mbarrier (the packed
//   tables of a placed graph need not be 16-byte aligned). The slot loop
//   then reads shared memory only, and writes out.
// - A lane owns 16 bytes of channels (8 bf16 or 4 f32): one shared load a
//   gathered row, its index handled once for all of them.
// Shapes a tensor map cannot take (a row stride or base pointer that is not
// 16-byte aligned, a slice wider than H) fill the same ring and buffers
// with ordinary loads by the producer warp. The layout (slice, stage rows,
// ring rows, buffers, strips) is worked out in Python (ops/windowed.py:
// window_plan); the launchers check it and launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "slot_loop.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;   // dynamic shared memory of an H100 block
constexpr int kWarps = stinet::kThreads / 32;   // consumer warps
constexpr int kBlock = stinet::kThreads + 32;   // and one producer warp
// Blocks an SM the registers are budgeted for: ops/windowed.py's
// TARGET_BLOCKS_PER_SM, which sizes the shared memory for as many.
constexpr int kMinBlocks = 2;
constexpr int kBarrierBytes = 16;  // a stage's full and empty mbarriers
// A wait that outlasts this many clock cycles (about 2 s) has lost its
// copy or its consumers: trap instead of hanging the card.
constexpr long long kHangCycles = 1LL << 32;

// The launch layout of ops/windowed.py:WindowPlan, and the launch's shape.
struct Plan {
  int V, H, D, tile, halo, W;
  int cs, sub, ring, bufs, buf_rows, strip_tiles;
  int tma;    // 1: TMA fills the ring; 0: the producer warp's loads
  int g_vec;  // 1: 16-byte loads of the step epilogue's g; 0: by element
};

__device__ __forceinline__ int window_start(const Plan& pl, int i) {
  return min(max(i * pl.tile - pl.halo, 0), pl.V - pl.W);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* ptr) {
  return *reinterpret_cast<const uint4*>(ptr);
}

// Sixteen bytes of channels a lane (slot_loop.cuh)
using stinet::store16;
using stinet::Vec16;

// A lane's channels [c, c + kN) of a row in device memory, as f32, zero
// past channel H (`left` of them inside the row): one 16-byte load where
// `whole`, else element loads.
template <typename T>
__device__ __forceinline__ void load_row(const T* ptr, int left, bool whole,
                                         float* f) {
  if (whole) {
    Vec16<T>::unpack(__ldg(reinterpret_cast<const uint4*>(ptr)), f);
    return;
  }
#pragma unroll
  for (int i = 0; i < Vec16<T>::kN; ++i) {
    f[i] = i < left ? stinet::Elem<T>::get(ptr[i]) : 0.f;
  }
}

// The gathered rows of one tile, read from the ring: row x of the strip
// lives in ring row (x - base) mod R. local() traps on a row outside the
// tile's window, which is resident as a whole while the tile computes.
template <typename T>
struct RingRows {
  const T* ring;
  int w0, W, o, R, cs;  // o = (w0 - base) mod R
  __device__ __forceinline__ uint4 load(int idx, int off) const {
    return load16(ring + idx * cs + off);
  }
  __device__ __forceinline__ int local(int row) const {
    const int r = row - w0;
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(W)) __trap();
    const int idx = r + o;
    return idx >= R ? idx - R : idx;
  }
};

// One chunk of own rows [r0, r0 + buf_rows) in a buffer: x ([buf_rows, cs]:
// p, or q for dq), the slot indices ([buf_rows, D]) and their live counts.
template <typename T>
struct Chunk {
  const T* x;
  const int* idx;
  const float* count;
  int r0;
};

// The slot loops of slot_loop.cuh with 16 bytes of channels a lane, cs / kN
// lanes a row, and the arithmetic element by element as there (the add
// rounded to T, compare and relu in f32, f32 sums in slot order, dead slots
// skipped), so the bits are the plain versions'. Channels at or past H hold
// zeros and are not stored. mean_deg (relu) and g (step), where not null,
// take the epilogues of the file's head.
template <typename T, int kMode>
__device__ void ring_receiver(const Plan& pl, const Chunk<T>& ch,
                              const RingRows<T>& q,
                              const float* __restrict__ mean_deg,
                              const T* __restrict__ g, T* __restrict__ out,
                              int c0) {
  using V = Vec16<T>;
  const int lanes = pl.cs / V::kN;
  const int off = (threadIdx.x % lanes) * V::kN, c = c0 + off;
  if (c >= pl.H) return;
  for (int rl = threadIdx.x / lanes; rl < pl.buf_rows;
       rl += stinet::kThreads / lanes) {
    float pv[V::kN], acc[V::kN];
    V::unpack(load16(ch.x + rl * pl.cs + off), pv);
#pragma unroll
    for (int i = 0; i < V::kN; ++i) acc[i] = 0.f;
    const int64_t row = ch.r0 + rl;
    const bool mean = kMode == stinet::kRelu && mean_deg != nullptr;
    const float scale =
        mean ? stinet::mean_scale<T>(__ldg(mean_deg + row)) : 1.f;
    const int dv = min(static_cast<int>(ch.count[rl]), pl.D);
    const int* irow = ch.idx + rl * pl.D;
    for (int d0 = 0; d0 < dv; d0 += stinet::kAhead) {
      int slot[stinet::kAhead];
#pragma unroll
      for (int k = 0; k < stinet::kAhead; ++k) {
        slot[k] = d0 + k < dv ? irow[d0 + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < stinet::kAhead; ++k) {
        if (d0 + k >= dv) break;
        float qv[V::kN];
        V::unpack(q.load(q.local(slot[k]), off), qv);
#pragma unroll
        for (int i = 0; i < V::kN; ++i) {
          const float z = stinet::Elem<T>::add(pv[i], qv[i]);
          acc[i] = acc[i] + (kMode == stinet::kRelu ? stinet::relu(z)
                                                    : stinet::step(z));
        }
      }
    }
    if (mean) stinet::scale_rounded<T, V::kN>(acc, scale);
    if (kMode == stinet::kStep && g != nullptr) {
      float gv[V::kN];
      load_row(g + row * pl.H + c, pl.H - c, pl.g_vec, gv);
#pragma unroll
      for (int i = 0; i < V::kN; ++i) {
        acc[i] = __fmul_rn(gv[i], stinet::Elem<T>::round(acc[i]));
      }
    }
    store16(out + row * pl.H + c, acc, pl.H - c, pl.tma);
  }
}

template <typename T>
__device__ void ring_sender(const Plan& pl, const Chunk<T>& ch,
                            const RingRows<T>& g, const RingRows<T>& p,
                            T* __restrict__ out, int c0) {
  using V = Vec16<T>;
  const int lanes = pl.cs / V::kN;
  const int off = (threadIdx.x % lanes) * V::kN, c = c0 + off;
  if (c >= pl.H) return;
  for (int sl = threadIdx.x / lanes; sl < pl.buf_rows;
       sl += stinet::kThreads / lanes) {
    float qv[V::kN], acc[V::kN];
    V::unpack(load16(ch.x + sl * pl.cs + off), qv);
#pragma unroll
    for (int i = 0; i < V::kN; ++i) acc[i] = 0.f;
    const int dv = min(static_cast<int>(ch.count[sl]), pl.D);
    const int* irow = ch.idx + sl * pl.D;
    for (int j0 = 0; j0 < dv; j0 += stinet::kAhead) {
      int slot[stinet::kAhead];
#pragma unroll
      for (int k = 0; k < stinet::kAhead; ++k) {
        slot[k] = j0 + k < dv ? irow[j0 + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < stinet::kAhead; ++k) {
        if (j0 + k >= dv) break;
        const int r = g.local(slot[k]);
        float gv[V::kN], pv[V::kN];
        V::unpack(g.load(r, off), gv);
        V::unpack(p.load(r, off), pv);
#pragma unroll
        for (int i = 0; i < V::kN; ++i) {
          const float z = stinet::Elem<T>::add(pv[i], qv[i]);
          acc[i] = acc[i] + gv[i] * stinet::step(z);
        }
      }
    }
    store16(out + static_cast<int64_t>(ch.r0 + sl) * pl.H + c, acc,
            pl.H - c, pl.tma);
  }
}

// The strip of this block: its tiles [i_begin, i_end) and the first stage
// their windows span.
struct Strip {
  int i_begin, i_end, k_begin;
  __device__ Strip(const Plan& pl) {
    i_begin = blockIdx.x * pl.strip_tiles;
    i_end = min(i_begin + pl.strip_tiles, pl.V / pl.tile);
    k_begin = window_start(pl, i_begin) / pl.sub;
  }
};

__host__ __device__ __forceinline__ int64_t round128(int64_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// Byte layout of a block's dynamic shared memory: `arrays` rings, `bufs`
// buffers of buf_rows own rows' operands (x, indices, counts), then the
// mbarriers (full and empty of each ring stage, then of each buffer).
// ops/windowed.py:window_plan computes the same total.
struct Layout {
  int64_t ring, x, idx, count, buffer, barriers, total;
  __host__ __device__ Layout(const Plan& pl, int arrays, int elem) {
    ring = static_cast<int64_t>(pl.ring) * pl.cs * elem;
    x = round128(static_cast<int64_t>(pl.buf_rows) * pl.cs * elem);
    idx = round128(static_cast<int64_t>(pl.buf_rows) * pl.D * 4);
    count = round128(static_cast<int64_t>(pl.buf_rows) * 4);
    buffer = x + idx + count;
    barriers = arrays * ring + pl.bufs * buffer;
    total = barriers + kBarrierBytes * (pl.ring / pl.sub + pl.bufs);
  }
};

template <typename T, int kArrays>
struct Shared {
  T* ring[kArrays];
  unsigned char* buffers;
  Layout lay;
  uint64_t *full, *empty, *buf_full, *buf_empty;
  __device__ T* x(int b) const {
    return reinterpret_cast<T*>(buffers + b * lay.buffer);
  }
  __device__ int* idx(int b) const {
    return reinterpret_cast<int*>(buffers + b * lay.buffer + lay.x);
  }
  __device__ float* count(int b) const {
    return reinterpret_cast<float*>(buffers + b * lay.buffer + lay.x +
                                    lay.idx);
  }
};

// What fills the rings and the buffers: each [V, H] array's tensor map
// (TMA) and pointer (ordinary loads), the index table and the counts.
template <typename T, int kArrays>
struct Sources {
  const CUtensorMap* ring_map[kArrays];
  const T* ring_src[kArrays];
  const CUtensorMap* x_map;
  const T* x;
  const int* idx;
  const float* count;
};

// Carve the dynamic shared memory (Layout) and initialise the barriers.
template <typename T, int kArrays>
__device__ Shared<T, kArrays> setup(const Plan& pl, unsigned char* smem) {
  Shared<T, kArrays> sm{{}, nullptr, Layout(pl, kArrays, sizeof(T))};
  for (int a = 0; a < kArrays; ++a) {
    sm.ring[a] = reinterpret_cast<T*>(smem + a * sm.lay.ring);
  }
  sm.buffers = smem + kArrays * sm.lay.ring;
  const int stages = pl.ring / pl.sub;
  sm.full = reinterpret_cast<uint64_t*>(smem + sm.lay.barriers);
  sm.empty = sm.full + stages;
  sm.buf_full = sm.empty + stages;
  sm.buf_empty = sm.buf_full + pl.bufs;
  if (threadIdx.x == 0) {
    const uint32_t fills = pl.tma ? 1 : 32;
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], fills);
      mbar_init(&sm.empty[s], kWarps);
    }
    for (int b = 0; b < pl.bufs; ++b) {
      mbar_init(&sm.buf_full[b], fills);
      mbar_init(&sm.buf_empty[b], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// 4-byte asynchronous copies, tracked by an mbarrier: the barrier's phase
// cannot complete before every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_track(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Rows [row0, row0 + rows) x channels [c0, c0 + cs) of a [V, H] array into
// dst ([rows, cs]), zero past channel H: the ordinary-load fill, one warp.
template <typename T>
__device__ void copy_rows(T* dst, const T* src, const Plan& pl, int row0,
                          int rows, int c0, int lane) {
  for (int e = lane; e < rows * pl.cs; e += 32) {
    const int r = row0 + e / pl.cs, c = c0 + e % pl.cs;
    dst[e] = c < pl.H ? src[static_cast<int64_t>(r) * pl.H + c]
                      : stinet::Elem<T>::zero();
  }
}

// The producer's fill of own-row chunk n (rows r0...) into buffer
// n % bufs, once the consumers released the chunk that held it before. The
// index rows and counts go by 4-byte cp.async from every lane (the packed
// tables of a placed graph need not be 16-byte aligned); x by one TMA box,
// or by ordinary loads.
template <typename T, int kArrays>
__device__ void load_buffer(const Plan& pl, const Shared<T, kArrays>& sm,
                            const Sources<T, kArrays>& src, int n, int r0,
                            int c0, int lane) {
  const int b = n % pl.bufs, round = n / pl.bufs;
  if (round > 0) mbar_wait(&sm.buf_empty[b], (round - 1) & 1);
  const int* idx = src.idx + static_cast<int64_t>(r0) * pl.D;
  for (int e = lane; e < pl.buf_rows * pl.D; e += 32) {
    cp_async4(sm.idx(b) + e, idx + e);
  }
  for (int e = lane; e < pl.buf_rows; e += 32) {
    cp_async4(sm.count(b) + e, src.count + r0 + e);
  }
  cp_async_track(&sm.buf_full[b]);
  if (pl.tma) {
    __syncwarp();  // every lane's tracking precedes the arrival below
    if (lane == 0) {
      mbar_expect_tx(&sm.buf_full[b], pl.buf_rows * pl.cs * sizeof(T));
      tma_load_2d(sm.x(b), src.x_map, &sm.buf_full[b], c0, r0);
    }
    return;
  }
  copy_rows(sm.x(b), src.x, pl, r0, pl.buf_rows, c0, lane);
  mbar_arrive(&sm.buf_full[b]);  // one of 32: each lane after its stores
}

// The producer's fill of ring stage k into slot (k - k_begin) % stages,
// once the consumers released the stage that held the slot before.
template <typename T, int kArrays>
__device__ void load_stage(const Plan& pl, const Shared<T, kArrays>& sm,
                           const Sources<T, kArrays>& src, int k,
                           int k_begin, int c0, int lane) {
  const int stages = pl.ring / pl.sub;
  const int stage_elems = pl.sub * pl.cs;
  const int m = k - k_begin, slot = m % stages, round = m / stages;
  if (round > 0) mbar_wait(&sm.empty[slot], (round - 1) & 1);
  if (pl.tma) {
    if (lane == 0) {
      mbar_expect_tx(&sm.full[slot], kArrays * stage_elems * sizeof(T));
#pragma unroll
      for (int a = 0; a < kArrays; ++a) {
        tma_load_2d(sm.ring[a] + slot * stage_elems, src.ring_map[a],
                    &sm.full[slot], c0, k * pl.sub);
      }
    }
    return;
  }
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    copy_rows(sm.ring[a] + slot * stage_elems, src.ring_src[a], pl,
              k * pl.sub, pl.sub, c0, lane);
  }
  mbar_arrive(&sm.full[slot]);
}

// Producer warp, all 32 lanes. For each tile of the strip, in order: its
// first chunk of own-row operands, the ring stages up to the end of its
// window, then its other chunks.
template <typename T, int kArrays>
__device__ void produce(const Plan& pl, const Strip& st,
                        const Shared<T, kArrays>& sm,
                        const Sources<T, kArrays>& src, int c0) {
  const int lane = threadIdx.x & 31;
  const int chunks = pl.tile / pl.buf_rows;
  int k = st.k_begin;
  for (int i = st.i_begin; i < st.i_end; ++i) {
    const int n0 = (i - st.i_begin) * chunks, t0 = i * pl.tile;
    load_buffer(pl, sm, src, n0, t0, c0, lane);
    for (const int k_hi = (window_start(pl, i) + pl.W) / pl.sub; k < k_hi;
         ++k) {
      load_stage(pl, sm, src, k, st.k_begin, c0, lane);
    }
    for (int j = 1; j < chunks; ++j) {
      load_buffer(pl, sm, src, n0 + j, t0 + j * pl.buf_rows, c0, lane);
    }
  }
}

// Consumer warps: for each tile of the strip, wait for the stages of its
// window; for each chunk of its rows, wait for the operands, run
// `chunk_fn(r0, w0, o, buffer)` and release the buffer; after the tile,
// release the stages the next tile's window drops.
template <typename T, int kArrays, typename ChunkFn>
__device__ void consume(const Plan& pl, const Strip& st,
                        const Shared<T, kArrays>& sm, ChunkFn chunk_fn) {
  const int stages = pl.ring / pl.sub;
  const int chunks = pl.tile / pl.buf_rows;
  const int base = st.k_begin * pl.sub;
  const bool leader = (threadIdx.x & 31) == 0;
  int k_ready = st.k_begin;
  for (int i = st.i_begin; i < st.i_end; ++i) {
    const int w0 = window_start(pl, i), o = (w0 - base) % pl.ring;
    for (const int k_hi = (w0 + pl.W) / pl.sub; k_ready < k_hi; ++k_ready) {
      const int m = k_ready - st.k_begin;
      mbar_wait(&sm.full[m % stages], (m / stages) & 1);
    }
    for (int j = 0; j < chunks; ++j) {
      const int n = (i - st.i_begin) * chunks + j, b = n % pl.bufs;
      mbar_wait(&sm.buf_full[b], (n / pl.bufs) & 1);
      chunk_fn(i * pl.tile + j * pl.buf_rows, w0, o, b);
      __syncwarp();
      if (leader) mbar_arrive(&sm.buf_empty[b]);
    }
    if (leader && i + 1 < st.i_end) {
      const int k_next = window_start(pl, i + 1) / pl.sub;
      for (int k = w0 / pl.sub; k < k_next; ++k) {
        mbar_arrive(&sm.empty[(k - st.k_begin) % stages]);
      }
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    windowed_receiver(__grid_constant__ const CUtensorMap q_map,
                      __grid_constant__ const CUtensorMap p_map,
                      const T* __restrict__ p, const T* __restrict__ q,
                      const int* __restrict__ nbr,
                      const float* __restrict__ deg,
                      const float* __restrict__ mean_deg,
                      const T* __restrict__ g, T* __restrict__ out,
                      const Plan pl) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Shared<T, 1> sm = setup<T, 1>(pl, smem);
  const Strip st(pl);
  const int c0 = blockIdx.y * pl.cs;
  if (threadIdx.x >= stinet::kThreads) {
    produce<T, 1>(pl, st, sm, Sources<T, 1>{{&q_map}, {q}, &p_map, p, nbr,
                                            deg}, c0);
    return;
  }
  consume<T, 1>(pl, st, sm, [&](int r0, int w0, int o, int b) {
    const Chunk<T> ch{sm.x(b), sm.idx(b), sm.count(b), r0};
    const RingRows<T> rows{sm.ring[0], w0, pl.W, o, pl.ring, pl.cs};
    ring_receiver<T, kMode>(pl, ch, rows, mean_deg, g, out, c0);
  });
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
    windowed_sender(__grid_constant__ const CUtensorMap g_map,
                    __grid_constant__ const CUtensorMap p_map,
                    __grid_constant__ const CUtensorMap q_map,
                    const bf16* __restrict__ q, const bf16* __restrict__ g,
                    const bf16* __restrict__ p, const int* __restrict__ rev,
                    const float* __restrict__ deg_out, bf16* __restrict__ out,
                    const Plan pl) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Shared<bf16, 2> sm = setup<bf16, 2>(pl, smem);
  const Strip st(pl);
  const int c0 = blockIdx.y * pl.cs;
  if (threadIdx.x >= stinet::kThreads) {
    produce<bf16, 2>(pl, st, sm,
                     Sources<bf16, 2>{{&g_map, &p_map}, {g, p}, &q_map, q,
                                      rev, deg_out},
                     c0);
    return;
  }
  consume<bf16, 2>(pl, st, sm, [&](int s0, int w0, int o, int b) {
    const Chunk<bf16> ch{sm.x(b), sm.idx(b), sm.count(b), s0};
    const RingRows<bf16> g_rows{sm.ring[0], w0, pl.W, o, pl.ring, pl.cs};
    const RingRows<bf16> p_rows{sm.ring[1], w0, pl.W, o, pl.ring, pl.cs};
    ring_sender<bf16>(pl, ch, g_rows, p_rows, out, c0);
  });
}

// --- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, so the library links against
// the CUDA runtime alone; null if the CUDA driver does not have it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// Whether TMA can fill the rings and buffers from the [V, H] array `rows`:
// a 16-byte aligned base and row stride, 16-byte box rows, 128-byte aligned
// ring stages, boxes of at most 256 rows and a slice no wider than H.
bool tma_fits(const Plan& pl, const void* rows, int elem) {
  return (reinterpret_cast<uintptr_t>(rows) & 15u) == 0 &&
         (static_cast<int64_t>(pl.H) * elem) % 16 == 0 &&
         (pl.cs * elem) % 16 == 0 && (pl.sub * pl.cs * elem) % 128 == 0 &&
         pl.cs <= pl.H && pl.sub <= 256 && pl.buf_rows <= 256;
}

// A [V, H] tensor map of `src` with a box of [box_rows x cs channels];
// false if the CUDA driver refuses it.
bool encode_map(CUtensorMap* map, const Plan& pl, const void* src,
                int box_rows, CUtensorMapDataType type, int elem) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(pl.H),
                              static_cast<cuuint64_t>(pl.V)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pl.H) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(pl.cs),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(src), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps of the `n` [V, H] arrays, the ring arrays first (boxes of
// sub rows) and the own-row array last (boxes of buf_rows), when TMA fits
// all of them (pl->tma = 1), else pl->tma = 0; false if the CUDA driver
// refuses a map.
bool encode_maps(Plan* pl, CUtensorMap* maps, const void* const* rows, int n,
                 CUtensorMapDataType type, int elem) {
  bool fits = true;
  for (int a = 0; a < n; ++a) fits = fits && tma_fits(*pl, rows[a], elem);
  pl->tma = fits;
  for (int a = 0; a < n && fits; ++a) {
    const int box_rows = a + 1 < n ? pl->sub : pl->buf_rows;
    if (!encode_map(&maps[a], *pl, rows[a], box_rows, type, elem)) {
      return false;
    }
  }
  return true;
}

// Check a plan against the geometry and the card: cudaErrorInvalidValue if
// it does not describe these shapes, cudaErrorInvalidConfiguration if its
// shared memory does not fit a block.
int check_plan(const Plan& pl, int arrays, int elem, int strips, int smem) {
  const bool power_of_two = pl.cs >= 8 && pl.cs <= 64 &&
                            (pl.cs & (pl.cs - 1)) == 0;
  if (pl.tile <= 0 || pl.V % pl.tile != 0 || pl.halo < 0 || pl.D < 0 ||
      pl.W != std::min(pl.tile + 2 * pl.halo, pl.V) || !power_of_two ||
      pl.sub <= 0 || pl.tile % pl.sub != 0 || pl.W % pl.sub != 0 ||
      (pl.W != pl.V && pl.halo % pl.sub != 0) || pl.ring < pl.W ||
      pl.ring % pl.sub != 0 || pl.bufs <= 0 || pl.buf_rows <= 0 ||
      pl.tile % pl.buf_rows != 0 || pl.strip_tiles <= 0 || strips <= 0) {
    return cudaErrorInvalidValue;
  }
  const int tiles = pl.V / pl.tile;
  if ((strips - 1) * pl.strip_tiles >= tiles ||
      strips * pl.strip_tiles < tiles) {
    return cudaErrorInvalidValue;
  }
  if (Layout(pl, arrays, elem).total != smem) return cudaErrorInvalidValue;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// The last launch: strips, slices, threads, smem, cs, sub, ring, bufs,
// buf_rows, strip_tiles, tma.
constexpr int kRecord = 11;
int g_last_launch[kRecord];

template <typename Kernel>
int launch_setup(Kernel kernel, const Plan& pl, int arrays, int elem,
                 int strips, int smem, int device, dim3* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int rc = check_plan(pl, arrays, elem, strips, smem);
  if (rc != cudaSuccess) return rc;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  *grid = dim3(strips, (pl.H + pl.cs - 1) / pl.cs);
  const int record[kRecord] = {strips, static_cast<int>(grid->y), kBlock,
                               smem, pl.cs, pl.sub, pl.ring, pl.bufs,
                               pl.buf_rows, pl.strip_tiles, pl.tma};
  for (int i = 0; i < kRecord; ++i) g_last_launch[i] = record[i];
  return cudaSuccess;
}

Plan make_plan(int V, int H, int D, int tile, int halo, int W, int cs,
               int sub, int ring, int bufs, int buf_rows, int strip_tiles) {
  return Plan{V,  H,   D,    tile,     halo,        W, cs,
              sub, ring, bufs, buf_rows, strip_tiles, 0, 0};
}

// mean_deg goes with relu mode only, g with step mode only.
template <typename T>
int receiver(const T* p, const T* q, const int* nbr, const float* deg,
             const float* mean_deg, const T* g, T* out, Plan pl, int strips,
             int smem, int mode, int device, cudaStream_t stream,
             CUtensorMapDataType type) {
  if (pl.V <= 0 || pl.H <= 0) return cudaSuccess;
  if ((mode != stinet::kRelu || g != nullptr) &&
      (mode != stinet::kStep || mean_deg != nullptr)) {
    return cudaErrorInvalidValue;
  }
  pl.g_vec = g != nullptr &&
             (static_cast<int64_t>(pl.H) * sizeof(T)) % 16 == 0 &&
             (reinterpret_cast<uintptr_t>(g) & 15u) == 0;
  auto kernel = mode == stinet::kRelu ? windowed_receiver<T, stinet::kRelu>
                                      : windowed_receiver<T, stinet::kStep>;
  CUtensorMap maps[2] = {};
  const void* rows[2] = {q, p};
  if (!encode_maps(&pl, maps, rows, 2, type, sizeof(T))) {
    return cudaErrorInvalidValue;
  }
  dim3 grid;
  const int rc = launch_setup(kernel, pl, 1, sizeof(T), strips, smem, device,
                              &grid);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, kBlock, smem, stream>>>(maps[0], maps[1], p, q, nbr, deg,
                                         mean_deg, g, out, pl);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..10] = the last launch's strips, slices, threads, dynamic shared
// memory, cs, sub, ring, bufs, buf_rows, strip_tiles and whether TMA
// filled the ring.
extern "C" void windowed_last_launch(int* out) {
  for (int i = 0; i < kRecord; ++i) out[i] = g_last_launch[i];
}

// p, q, out: [V, H] bf16; nbr: [V, D] int32; deg: [V] f32. mode 0 = relu,
// 1 = step. mean_deg: null, or with relu the [V] f32 total degrees to take
// the mean over; g: null, or with step the [V, H] bf16 gradient to multiply
// the counts by. tile divides V; halo is the band bound rounded up to 32;
// W = min(tile + 2*halo, V); cs, sub, ring, bufs, buf_rows, strip_tiles,
// strips and smem are ops/windowed.py:window_plan's. Launches on `stream`,
// returns the launch error.
extern "C" int windowed_edge_conv_sum_bf16(
    const void* p, const void* q, const int* nbr, const float* deg,
    const float* mean_deg, const void* g, void* out, int V, int H, int D,
    int tile, int halo, int W, int cs, int sub, int ring, int bufs,
    int buf_rows, int strip_tiles, int strips, int smem, int mode, int device,
    cudaStream_t stream) {
  return receiver(static_cast<const bf16*>(p), static_cast<const bf16*>(q),
                  nbr, deg, mean_deg, static_cast<const bf16*>(g),
                  static_cast<bf16*>(out),
                  make_plan(V, H, D, tile, halo, W, cs, sub, ring, bufs,
                            buf_rows, strip_tiles),
                  strips, smem, mode, device, stream,
                  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// K3b, the relu sum (or mean) on f32 rows. p, q, out: [V, H] f32; the rest
// as for windowed_edge_conv_sum_bf16.
extern "C" int windowed_edge_conv_sum_f32(
    const float* p, const float* q, const int* nbr, const float* deg,
    const float* mean_deg, float* out, int V, int H, int D, int tile,
    int halo, int W, int cs, int sub, int ring, int bufs, int buf_rows,
    int strip_tiles, int strips, int smem, int device, cudaStream_t stream) {
  return receiver(p, q, nbr, deg, mean_deg, static_cast<const float*>(nullptr),
                  out,
                  make_plan(V, H, D, tile, halo, W, cs, sub, ring, bufs,
                            buf_rows, strip_tiles),
                  strips, smem, stinet::kRelu, device, stream,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// q, g, p, out: [V, H] bf16; rev: [V, D] int32; deg_out: [V] f32. The
// rings hold g and p, two arrays.
extern "C" int windowed_dq_bf16(const void* q, const void* g, const void* p,
                                const int* rev, const float* deg_out,
                                void* out, int V, int H, int D, int tile,
                                int halo, int W, int cs, int sub, int ring,
                                int bufs, int buf_rows, int strip_tiles,
                                int strips, int smem, int device,
                                cudaStream_t stream) {
  if (V <= 0 || H <= 0) return cudaSuccess;
  Plan pl =
      make_plan(V, H, D, tile, halo, W, cs, sub, ring, bufs, buf_rows,
                strip_tiles);
  CUtensorMap maps[3] = {};
  const void* rows[3] = {g, p, q};
  if (!encode_maps(&pl, maps, rows, 3, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   sizeof(bf16))) {
    return cudaErrorInvalidValue;
  }
  dim3 grid;
  const int rc = launch_setup(windowed_sender, pl, 2, sizeof(bf16), strips,
                              smem, device, &grid);
  if (rc != cudaSuccess) return rc;
  windowed_sender<<<grid, kBlock, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q),
      static_cast<const bf16*>(g), static_cast<const bf16*>(p), rev, deg_out,
      static_cast<bf16*>(out), pl);
  return cudaGetLastError();
}
