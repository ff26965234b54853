// Slot loops of the EdgeConv backward, shared arithmetic of every
// EdgeConv kernel. The ELL dp and dq kernels (ell_edge_conv.cu) run the
// loops below on rows read from device memory; the K1 forward there and the
// windowed kernels (windowed_edge_conv.cu) share the element arithmetic
// (Elem, relu, step) and the 16-byte lane helpers (Vec16, store16).
//
// Receiver side (dp), one output row v, slots d < min(deg[v], D),
// s = idx[v, d]:
//   out[v] = sum_d g[v] * step(z),  z = T(p[v] + q[s]), step(z) = z > 0
// Sender side (dq), one output row s, slots j < min(deg_out[s], D),
// r = rev[s, j]:
//   out[s] = sum_j g[r] * step(T(p[r] + q[s]))
// The forward sums (relu(z), and step(z) in the windowed kernels) use the
// same arithmetic.
//
// Bit-identity with the plain torch versions (ops/ell.py, ops/windowed.py):
// the add p + q rounds to the element type T as torch's add does (f32 add,
// then round to nearest even for bf16); compare and relu run in f32, relu as
// x < 0 ? 0 : x so NaN passes; slots accumulate in f32 in slot order; slots
// past the degree are skipped, which equals the plain version's "+0.0" since
// the sum starts at +0.0 and never becomes -0.0; the output rounds to T with
// round to nearest even. The only product, g * step, is exact, so an FMA
// contraction cannot change a result either.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stinet {

constexpr int kThreads = 256;  // threads of every slot-loop block

enum Mode { kRelu = 0, kStep = 1 };  // the forward sums' modes

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(a + b));
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
};

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float step(float x) { return x > 0.f ? 1.f : 0.f; }

// Sixteen bytes of channels, what a lane loads, computes and stores: 4 f32
// or 8 bf16, unpacked to f32 exactly and packed with round to nearest even
// (Elem<T>::put's rounding).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]))) |
             static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])))
                 << 16;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A lane's channels [c, c + kN) of one output row: one 16-byte store where
// the row stride allows it (`whole`), else the channels below H one by one.
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* f, int left,
                                        bool whole) {
  if (whole) {
    *reinterpret_cast<uint4*>(dst) = Vec16<T>::pack(f);
    return;
  }
#pragma unroll
  for (int i = 0; i < Vec16<T>::kN; ++i) {
    if (i < left) dst[i] = Elem<T>::put(f[i]);
  }
}

// Where a block reads its gathered rows: straight from device memory, row
// stride H. local() maps a gathered row to the index get() takes.
template <typename T>
struct GlobalRows {
  const T* base;
  int H;
  __device__ __forceinline__ float get(int row, int c, int) const {
    return Elem<T>::get(base + static_cast<int64_t>(row) * H + c);
  }
  __device__ __forceinline__ int local(int row) const { return row; }
};

// Slot indices are read kAhead at a time, so their loads (and the gathers
// that follow) overlap; the sums still run in slot order.
constexpr int kAhead = 8;

// The receiver-side (dp) loop over rows [r_begin, r_end) of one channel
// slice [c0, c0 + cs): each lane owns two channels of one row, cs / 2 lanes
// a row.
template <typename T, typename Rows>
__device__ void receiver_rows(const T* __restrict__ p, const T* __restrict__ g,
                              const Rows& q, const int* __restrict__ idx,
                              const float* __restrict__ deg,
                              T* __restrict__ out, int r_begin, int r_end,
                              int H, int D, int c0, int cs) {
  const int lanes = cs / 2;
  const int off = 2 * (threadIdx.x % lanes);
  const int c = c0 + off;
  const bool has0 = c < H, has1 = c + 1 < H;
  for (int r = r_begin + threadIdx.x / lanes; r < r_end;
       r += blockDim.x / lanes) {
    const int64_t row = static_cast<int64_t>(r) * H;
    const float p0 = has0 ? Elem<T>::get(p + row + c) : 0.f;
    const float p1 = has1 ? Elem<T>::get(p + row + c + 1) : 0.f;
    const float g0 = has0 ? Elem<T>::get(g + row + c) : 0.f;
    const float g1 = has1 ? Elem<T>::get(g + row + c + 1) : 0.f;
    const int dv = min(static_cast<int>(deg[r]), D);
    const int* irow = idx + static_cast<int64_t>(r) * D;
    float a0 = 0.f, a1 = 0.f;
    for (int d0 = 0; d0 < dv; d0 += kAhead) {
      int slot[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        // read the slot only when it is live, then index with it
        slot[k] = d0 + k < dv ? __ldg(irow + d0 + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (d0 + k >= dv) break;
        const int s = q.local(slot[k]);
        if (has0) {
          const float z = Elem<T>::add(p0, q.get(s, c, off));
          a0 = a0 + g0 * step(z);
        }
        if (has1) {
          const float z = Elem<T>::add(p1, q.get(s, c + 1, off + 1));
          a1 = a1 + g1 * step(z);
        }
      }
    }
    if (has0) out[row + c] = Elem<T>::put(a0);
    if (has1) out[row + c + 1] = Elem<T>::put(a1);
  }
}

// The sender-side (dq) loop: gathered rows of g and of p, local q.
template <typename T, typename Rows>
__device__ void sender_rows(const T* __restrict__ q, const Rows& g,
                            const Rows& p, const int* __restrict__ rev,
                            const float* __restrict__ deg_out,
                            T* __restrict__ out, int s_begin, int s_end,
                            int H, int D, int c0, int cs) {
  const int lanes = cs / 2;
  const int off = 2 * (threadIdx.x % lanes);
  const int c = c0 + off;
  const bool has0 = c < H, has1 = c + 1 < H;
  for (int s = s_begin + threadIdx.x / lanes; s < s_end;
       s += blockDim.x / lanes) {
    const int64_t row = static_cast<int64_t>(s) * H;
    const float q0 = has0 ? Elem<T>::get(q + row + c) : 0.f;
    const float q1 = has1 ? Elem<T>::get(q + row + c + 1) : 0.f;
    const int dv = min(static_cast<int>(deg_out[s]), D);
    const int* irow = rev + static_cast<int64_t>(s) * D;
    float a0 = 0.f, a1 = 0.f;
    for (int j0 = 0; j0 < dv; j0 += kAhead) {
      int slot[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        slot[k] = j0 + k < dv ? __ldg(irow + j0 + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (j0 + k >= dv) break;
        const int r = g.local(slot[k]);
        if (has0) {
          const float z = Elem<T>::add(p.get(r, c, off), q0);
          a0 = a0 + g.get(r, c, off) * step(z);
        }
        if (has1) {
          const float z = Elem<T>::add(p.get(r, c + 1, off + 1), q1);
          a1 = a1 + g.get(r, c + 1, off + 1) * step(z);
        }
      }
    }
    if (has0) out[row + c] = Elem<T>::put(a0);
    if (has1) out[row + c + 1] = Elem<T>::put(a1);
  }
}

}  // namespace stinet
