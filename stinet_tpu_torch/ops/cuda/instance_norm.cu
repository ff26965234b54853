// Single-graph masked instance norm, f32.
//
//   n = max(num_valid, 1)
//   mean[c] = sum_{r < num_valid} x[r, c] / n
//   var[c]  = sum_{r < num_valid} (x[r, c] - mean[c])^2 / n    (centered)
//   out[r, c] = r < num_valid ? (x[r, c] - mean[c]) / sqrt(var[c] + eps) : 0
//
// Replaces the TPU kernel K2, pallas_instance_norm
// (stinet_tpu/ops/pallas/instance_norm.py:77, _forward :56-73, kernel
// :26-53). K2 takes the variance as sumsq/n - mean^2; the model's function,
// stinet_tpu/ops/norms.py:79-98 masked_instance_norm, takes the centered
// variance, and this kernel computes that.
//
// Bound: bytes. The least traffic is x read once and out written once; the
// three passes here read x three times (the second and third reads partly
// from the 50 MB L2, which holds a whole flagship activation). About 7
// flops per element.
//
// Design: the TPU kernel carried its column sums across a sequential grid
// in VMEM. Blocks on the card run in no order, so each reduction is two
// steps with no atomics, and the result does not change from run to run:
// blocks of 32 columns x 8 row lanes sum a chunk of 256 rows each into a
// partial [chunks, C]; then one thread per column sums the partials in
// chunk order. Done once for the mean and once for the centered sum of
// squares, then one elementwise pass normalizes and zeroes the pad rows.
// num_valid is read from device memory (as the TPU kernel's scalar
// prefetch did), so the caller never waits for the device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerChunk = 256;
constexpr int kCols = 32;   // columns per block (one warp across a row)
constexpr int kLanes = 8;   // row lanes per block

__device__ __forceinline__ int valid_rows(const int* num_valid, int V) {
  return min(max(*num_valid, 0), V);
}

// partial[chunk, c] = sum over the chunk's valid rows of x (mean == null)
// or of (x - mean[c])^2
__global__ void column_partials(const float* __restrict__ x,
                                const int* __restrict__ num_valid,
                                const float* __restrict__ mean,
                                float* __restrict__ partial, int V, int C) {
  __shared__ float lanes[kLanes][kCols];
  const int nv = valid_rows(num_valid, V);
  const int c = blockIdx.y * kCols + threadIdx.x;
  const int r0 = blockIdx.x * kRowsPerChunk;
  const int r1 = min(r0 + kRowsPerChunk, nv);
  float s = 0.f;
  if (c < C) {
    const float m = mean ? mean[c] : 0.f;
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
    partial[static_cast<int64_t>(blockIdx.x) * C + c] = t;
  }
}

// stat[c] = sum_k partial[k, c] / n           (inv_std == false: the mean)
// stat[c] = 1 / sqrt(sum_k partial / n + eps) (inv_std == true)
__global__ void finalize(const float* __restrict__ partial, int chunks,
                         const int* __restrict__ num_valid, int V, int C,
                         float eps, bool inv_std, float* __restrict__ stat) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) {
    s += partial[static_cast<int64_t>(k) * C + c];
  }
  const float n = fmaxf(static_cast<float>(valid_rows(num_valid, V)), 1.f);
  const float m = s / n;
  stat[c] = inv_std ? 1.f / sqrtf(m + eps) : m;
}

__global__ void normalize_rows(const float* __restrict__ x,
                               const int* __restrict__ num_valid,
                               const float* __restrict__ mean,
                               const float* __restrict__ inv_std,
                               float* __restrict__ out, int V, int C) {
  const int nv = valid_rows(num_valid, V);
  const int64_t total = static_cast<int64_t>(V) * C;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / C);
    const int c = static_cast<int>(i - static_cast<int64_t>(r) * C);
    out[i] = r < nv ? (x[i] - mean[c]) * inv_std[c] : 0.f;
  }
}

int chunks_of(int V) { return (V + kRowsPerChunk - 1) / kRowsPerChunk; }

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of scratch memory masked_instance_norm_f32 needs for [V, C].
extern "C" int64_t masked_instance_norm_f32_scratch_floats(int V, int C) {
  return static_cast<int64_t>(chunks_of(V)) * C + 2 * static_cast<int64_t>(C);
}

// x, out: [V, C] f32; num_valid: one int32 in device memory; scratch: as
// many floats as masked_instance_norm_f32_scratch_floats(V, C). Launches
// on `stream` and returns cudaGetLastError().
extern "C" int masked_instance_norm_f32(const float* x, const int* num_valid,
                                        float* out, float* scratch, int V,
                                        int C, float eps, int device,
                                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (V <= 0 || C <= 0) return cudaSuccess;
  const int chunks = chunks_of(V);
  float* partial = scratch;
  float* mean = scratch + static_cast<int64_t>(chunks) * C;
  float* inv_std = mean + C;

  const dim3 red_block(kCols, kLanes);
  const dim3 red_grid(chunks, (C + kCols - 1) / kCols);
  const int fin_threads = 128;
  const int fin_blocks = (C + fin_threads - 1) / fin_threads;

  column_partials<<<red_grid, red_block, 0, stream>>>(x, num_valid, nullptr,
                                                      partial, V, C);
  finalize<<<fin_blocks, fin_threads, 0, stream>>>(partial, chunks, num_valid,
                                                   V, C, eps, false, mean);
  column_partials<<<red_grid, red_block, 0, stream>>>(x, num_valid, mean,
                                                      partial, V, C);
  finalize<<<fin_blocks, fin_threads, 0, stream>>>(partial, chunks, num_valid,
                                                   V, C, eps, true, inv_std);
  const int64_t total = static_cast<int64_t>(V) * C;
  const int threads = 256;
  // grid-stride loop: cap the grid, each thread takes several elements
  const int64_t needed = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(needed < (1 << 20) ? needed : (1 << 20));
  normalize_rows<<<blocks, threads, 0, stream>>>(x, num_valid, mean, inv_std,
                                                 out, V, C);
  return cudaGetLastError();
}
