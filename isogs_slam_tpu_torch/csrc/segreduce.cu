// Contiguous-segment row sum for Hopper (sm_90a):
//   out[c, n] = sum_{r in [off[n], off[n+1])} d_exp[r, c]   (f32 accumulate)
//
// Replaces the TPU kernel isogs_slam_tpu/ops/segreduce.py `_kernel`
// (reached through `segment_reduce_rows`). The Pallas kernel pads rows to
// 128 lanes, aligns each block's scan start to 8 rows and reduces with a
// boundary-mask matmul on the MXU; those are TPU layout rules and are not
// carried over. The rows are the mapping backward's per-(tile, slot)
// gradients written back in gaussian-major expansion order, so each
// Gaussian's rows are contiguous and the reduction needs no atomics.
//
// What bounds it on this card: bytes. Each input row (L values, bf16 on the
// main path) is read once and each output value written once, a few flops
// per byte. The design: one thread per Gaussian accumulates its own rows in
// registers; neighbouring threads own neighbouring segments, so a warp's
// reads cover one contiguous stretch of rows, and the planar [L, N] output
// is written with neighbouring threads on neighbouring addresses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LMAX = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename InT>
__global__ void __launch_bounds__(THREADS)
segreduce_kernel(const InT* __restrict__ d_exp,
                 const int* __restrict__ offsets, int N, int L,
                 float* __restrict__ out) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int s = offsets[n], e = offsets[n + 1];
  float acc[LMAX];
#pragma unroll
  for (int c = 0; c < LMAX; ++c) acc[c] = 0.f;
  for (int r = s; r < e; ++r) {
    const InT* row = d_exp + (size_t)r * L;
#pragma unroll
    for (int c = 0; c < LMAX; ++c)
      if (c < L) acc[c] += load(row + c);
  }
#pragma unroll
  for (int c = 0; c < LMAX; ++c)
    if (c < L) out[(size_t)c * N + n] = acc[c];
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for more than LMAX columns.
extern "C" int segreduce(const void* d_exp, int in_bf16, const int* offsets,
                         int N, int L, float* out, void* stream) {
  if (L > LMAX || L < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (N + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    segreduce_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)d_exp, offsets, N, L, out);
  else
    segreduce_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)d_exp, offsets, N, L, out);
  return (int)cudaGetLastError();
}
