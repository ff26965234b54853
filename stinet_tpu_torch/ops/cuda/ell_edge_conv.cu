// EdgeConv message sum over ELL neighbour tables, f32 forward.
//
//   out[v, :] = sum_{d < min(deg[v], D)} relu(p[v, :] + q[nbr[v, d], :])
//
// Replaces the TPU kernel K1, pallas_ell_edge_conv_sum
// (stinet_tpu/ops/pallas/gather_pipeline.py:102, kernel :38-99), which
// computes the same sum as the f32 XLA path stinet_tpu/ops/ell.py:66-93.
//
// Bound: bytes. Each output element costs 3 flops per valid slot (add, max,
// add) against one gathered 4-byte q element, far below the card's ratio of
// flops to bytes. The unavoidable traffic is p, q, nbr, deg and out once
// each; gathered q rows that several receivers share are served from L2.
//
// Design: one warp per receiver row, lanes across the channels with float4
// loads when H % 4 == 0 and the rows are 16-byte aligned (every flagship
// width: H = 128, 256, 512), scalar loads otherwise. The neighbour index is
// a warp-uniform load; each q row is read as one coalesced segment. Slots
// are accumulated in f32 in order d = 0..deg-1, exactly the order of the
// plain version (ops/ell.py), and the loop has no multiply, so no FMA
// contraction can occur: the result is bit-identical to the plain version.
// Skipped slots d >= deg contribute +0.0 there, which leaves a sum that
// starts at +0.0 and only adds values >= 0 unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// relu that propagates NaN like torch.relu (x < 0 is false for NaN)
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

__global__ void ell_fwd_vec4(const float* __restrict__ p,
                             const float* __restrict__ q,
                             const int* __restrict__ nbr,
                             const float* __restrict__ deg,
                             float* __restrict__ out, int V, int H, int D) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= V) return;
  const int dv = min(static_cast<int>(deg[row]), D);
  const int* nrow = nbr + static_cast<int64_t>(row) * D;
  const int h4 = H / 4;
  const float4* prow =
      reinterpret_cast<const float4*>(p + static_cast<int64_t>(row) * H);
  float4* orow = reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * H);
  for (int c = lane; c < h4; c += 32) {
    const float4 pv = prow[c];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int d = 0; d < dv; ++d) {
      const int s = __ldg(nrow + d);
      const float4 qv = __ldg(
          reinterpret_cast<const float4*>(q + static_cast<int64_t>(s) * H) + c);
      acc.x = acc.x + relu(pv.x + qv.x);
      acc.y = acc.y + relu(pv.y + qv.y);
      acc.z = acc.z + relu(pv.z + qv.z);
      acc.w = acc.w + relu(pv.w + qv.w);
    }
    orow[c] = acc;
  }
}

__global__ void ell_fwd_scalar(const float* __restrict__ p,
                               const float* __restrict__ q,
                               const int* __restrict__ nbr,
                               const float* __restrict__ deg,
                               float* __restrict__ out, int V, int H, int D) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= V) return;
  const int dv = min(static_cast<int>(deg[row]), D);
  const int* nrow = nbr + static_cast<int64_t>(row) * D;
  const float* prow = p + static_cast<int64_t>(row) * H;
  float* orow = out + static_cast<int64_t>(row) * H;
  for (int c = lane; c < H; c += 32) {
    const float pv = prow[c];
    float acc = 0.f;
    for (int d = 0; d < dv; ++d) {
      const int s = __ldg(nrow + d);
      acc = acc + relu(pv + __ldg(q + static_cast<int64_t>(s) * H + c));
    }
    orow[c] = acc;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" const char* stinet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p, q, out: [V, H] f32 (q may have any row count the indices stay inside);
// nbr: [V, D] int32 with every slot a valid row of q; deg: [V] f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ell_edge_conv_sum_fwd_f32(const float* p, const float* q,
                                         const int* nbr, const float* deg,
                                         float* out, int V, int H, int D,
                                         int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (V <= 0 || H <= 0) return cudaSuccess;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((V + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (H % 4 == 0 && aligned16(p) && aligned16(q) && aligned16(out)) {
    ell_fwd_vec4<<<grid, block, 0, stream>>>(p, q, nbr, deg, out, V, H, D);
  } else {
    ell_fwd_scalar<<<grid, block, 0, stream>>>(p, q, nbr, deg, out, V, H, D);
  }
  return cudaGetLastError();
}
