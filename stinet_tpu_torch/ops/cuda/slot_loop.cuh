// Shared arithmetic of every EdgeConv kernel: the element arithmetic
// (Elem, relu, step) and the 16-byte lane helpers (Vec16, store16) of the
// ELL row loops (ell_edge_conv.cu: the forward, dp and dq) and of the
// windowed kernels (windowed_edge_conv.cu), and the windowed slot loops'
// batch of indices (kAhead).
//
// Receiver side (the forward and dp), one output row v, slots
// d < min(deg[v], D), s = idx[v, d], z = T(p[v] + q[s]):
//   out[v] = sum_d relu(z)            (the forward)
//   out[v] = sum_d g[v] * step(z),    step(z) = z > 0   (dp)
// Sender side (dq), one output row s, slots j < min(deg_out[s], D),
// r = rev[s, j]:
//   out[s] = sum_j g[r] * step(T(p[r] + q[s]))
// The windowed forward sums (relu(z), and step(z) alone) use the same
// arithmetic. The mean over the total degree can be taken in the same
// epilogue (mean_scale, scale_rounded): round to T, times the scale in f32,
// round to T, the plain tail's roundings in its order.
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
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(a + b));
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
  // v rounded to bf16 and back: put's value as an f32
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
};

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float step(float x) { return x > 0.f ? 1.f : 0.f; }

// The EdgeConv mean's scale of a row whose total degree is `degree`, as the
// plain tail computes it (ops/ell.py:mean_scale_plain): the degree rounded
// to T, clamped at 1 (a NaN stays NaN, as torch.clamp leaves it) and
// inverted with IEEE round to nearest, which is torch's reciprocal.
template <typename T>
__device__ __forceinline__ float mean_scale(float degree) {
  const float d = Elem<T>::round(degree);
  return __frcp_rn(d < 1.f ? 1.f : d);
}

// f32 values as the plain tail leaves them before its last cast: each
// rounded to T, then times `scale` in f32 (round to nearest, never
// contracted). The store rounds to T once more.
template <typename T, int kN>
__device__ __forceinline__ void scale_rounded(float* x, float scale) {
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = __fmul_rn(Elem<T>::round(x[i]), scale);
}

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

// Slot indices the windowed slot loops (windowed_edge_conv.cu) read at a
// time, so their loads (and the gathers that follow) overlap; the sums
// still run in slot order.
constexpr int kAhead = 8;

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

}  // namespace stinet
