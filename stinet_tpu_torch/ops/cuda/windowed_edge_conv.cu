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
// ops/windowed.py). Relu runs on bf16 rows (K3a) and on f32 rows (K3b);
// step and dq on bf16 rows. K3b is bit for bit the f32 K1
// (ell_edge_conv.cu): the same loop with rows read from shared memory. The
// TPU split each f32 row into three bf16 planes because its one-hot MXU
// gather is exact only in bf16; the card stages the f32 rows themselves.
//
// Every live slot of a receiver tile [i*T, (i+1)*T) points into the window
// [w0, w0 + W), w0 = clamp(i*T - halo, 0, V - W), W = min(T + 2*halo, V):
// the graph builder bands the tables to the halo, and the reverse table is
// banded by symmetry. On the TPU the window streamed into VMEM and a one-hot
// matmul on the MXU did the gather. Here a block stages the window of one
// channel slice in shared memory with coalesced loads and gathers from it
// directly. The whole window does not fit (level 0: 768 rows x 128 bf16 =
// 192 KiB, and dq stages g and p; level 1 in f32: 512 rows x 256 f32 =
// 512 KiB), so a block takes one slice of cs channels (64 for relu/step,
// 32 for dq, halved while the window would not fit): 96 KiB at the
// flagship's bf16 level 0, 128 KiB at its f32 level 1. A slot is tested
// against the degree before its index is used, since pad slots point at the
// trash row, outside most windows.
//
// Bound: bytes. The window rows are read once per tile (about 1 + 2*halo/T
// times q, or g and p), plus nbr, deg, p and out once; the arithmetic is a
// few f32 operations per gathered element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "slot_loop.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the largest dynamic shared memory a block of an H100 may take
constexpr int kMaxSmem = 232448;

template <typename T, int kMode>
__global__ void __launch_bounds__(stinet::kThreads)
    windowed_receiver(const T* __restrict__ p, const T* __restrict__ q,
                      const int* __restrict__ nbr,
                      const float* __restrict__ deg, T* __restrict__ out,
                      int V, int H, int D, int tile, int halo, int W, int cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  const int t0 = blockIdx.x * tile;
  const int w0 = min(max(t0 - halo, 0), V - W);
  const int c0 = blockIdx.y * cs;
  stinet::stage_window(win, q, w0, W, H, c0, cs);
  __syncthreads();
  const stinet::WindowRows<T> rows{win, w0, W, cs};
  stinet::receiver_rows<T, kMode>(p, nullptr, rows, nbr, deg, out, t0,
                                  t0 + tile, H, D, c0, cs);
}

__global__ void __launch_bounds__(stinet::kThreads)
    windowed_sender(const bf16* __restrict__ q, const bf16* __restrict__ g,
                    const bf16* __restrict__ p, const int* __restrict__ rev,
                    const float* __restrict__ deg_out, bf16* __restrict__ out,
                    int V, int H, int D, int tile, int halo, int W, int cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* g_win = reinterpret_cast<bf16*>(smem);
  bf16* p_win = g_win + W * cs;
  const int t0 = blockIdx.x * tile;
  const int w0 = min(max(t0 - halo, 0), V - W);
  const int c0 = blockIdx.y * cs;
  stinet::stage_window(g_win, g, w0, W, H, c0, cs);
  stinet::stage_window(p_win, p, w0, W, H, c0, cs);
  __syncthreads();
  const stinet::WindowRows<bf16> g_rows{g_win, w0, W, cs};
  const stinet::WindowRows<bf16> p_rows{p_win, w0, W, cs};
  stinet::sender_rows<bf16>(q, g_rows, p_rows, rev, deg_out, out, t0,
                            t0 + tile, H, D, c0, cs);
}

// The channel slice: `widest` channels, halved while the staged windows
// (`arrays` of them, `elem` bytes an element) would not fit a block; 0 when
// even 8 do not.
int slice_width(int W, int arrays, int widest, int elem) {
  for (int cs = widest; cs >= 8; cs /= 2) {
    if (static_cast<int64_t>(arrays) * W * cs * elem <= kMaxSmem) {
      return cs;
    }
  }
  return 0;
}

bool geometry_ok(int V, int tile, int halo, int W) {
  return tile > 0 && V % tile == 0 && halo >= 0 && W > 0 && W <= V &&
         (W == V || W >= tile + 2 * halo);
}

// Checks the geometry, picks the channel slice and lets `kernel` take the
// shared memory of `arrays` windows of it; *cs_out and *smem_out are the
// launch's slice width and dynamic shared memory bytes.
template <typename Kernel>
int prepare(Kernel kernel, int arrays, int widest, int elem, int V, int tile,
            int halo, int W, int device, int* cs_out, int* smem_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!geometry_ok(V, tile, halo, W)) return cudaErrorInvalidValue;
  const int cs = slice_width(W, arrays, widest, elem);
  if (cs == 0) return cudaErrorInvalidConfiguration;
  const int smem = arrays * W * cs * elem;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  *cs_out = cs;
  *smem_out = smem;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p, q, out: [V, H] bf16; nbr: [V, D] int32; deg: [V] f32. mode 0 = relu,
// 1 = step. tile divides V; halo is the band bound rounded up to 32;
// W = min(tile + 2*halo, V). Launches on `stream`, returns the launch error.
extern "C" int windowed_edge_conv_sum_bf16(const void* p, const void* q,
                                           const int* nbr, const float* deg,
                                           void* out, int V, int H, int D,
                                           int tile, int halo, int W,
                                           int mode, int device,
                                           cudaStream_t stream) {
  if (V <= 0 || H <= 0) return cudaSuccess;
  if (mode != stinet::kRelu && mode != stinet::kStep) {
    return cudaErrorInvalidValue;
  }
  auto kernel = mode == stinet::kRelu
                    ? windowed_receiver<bf16, stinet::kRelu>
                    : windowed_receiver<bf16, stinet::kStep>;
  int cs = 0, smem = 0;
  const int rc = prepare(kernel, 1, 64, sizeof(bf16), V, tile, halo, W,
                         device, &cs, &smem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(V / tile, (H + cs - 1) / cs);
  kernel<<<grid, stinet::kThreads, smem, stream>>>(
      static_cast<const bf16*>(p), static_cast<const bf16*>(q), nbr, deg,
      static_cast<bf16*>(out), V, H, D, tile, halo, W, cs);
  return cudaGetLastError();
}

// K3b, the relu sum on f32 rows. p, q, out: [V, H] f32; nbr, deg, tile,
// halo and W as for windowed_edge_conv_sum_bf16.
extern "C" int windowed_edge_conv_sum_f32(const float* p, const float* q,
                                          const int* nbr, const float* deg,
                                          float* out, int V, int H, int D,
                                          int tile, int halo, int W,
                                          int device, cudaStream_t stream) {
  if (V <= 0 || H <= 0) return cudaSuccess;
  auto kernel = windowed_receiver<float, stinet::kRelu>;
  int cs = 0, smem = 0;
  const int rc = prepare(kernel, 1, 64, sizeof(float), V, tile, halo, W,
                         device, &cs, &smem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(V / tile, (H + cs - 1) / cs);
  kernel<<<grid, stinet::kThreads, smem, stream>>>(p, q, nbr, deg, out, V, H,
                                                   D, tile, halo, W, cs);
  return cudaGetLastError();
}

// q, g, p, out: [V, H] bf16; rev: [V, D] int32; deg_out: [V] f32.
extern "C" int windowed_dq_bf16(const void* q, const void* g, const void* p,
                                const int* rev, const float* deg_out,
                                void* out, int V, int H, int D, int tile,
                                int halo, int W, int device,
                                cudaStream_t stream) {
  if (V <= 0 || H <= 0) return cudaSuccess;
  int cs = 0, smem = 0;
  const int rc = prepare(windowed_sender, 2, 32, sizeof(bf16), V, tile, halo,
                         W, device, &cs, &smem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(V / tile, (H + cs - 1) / cs);
  windowed_sender<<<grid, stinet::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(g),
      static_cast<const bf16*>(p), rev, deg_out, static_cast<bf16*>(out), V,
      H, D, tile, halo, W, cs);
  return cudaGetLastError();
}
