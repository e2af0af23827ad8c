// Per-tile front-to-back alpha compositing for Hopper (sm_90a): forward and
// backward.
//
// Replaces the TPU kernels isogs_slam_tpu/ops/pallas_composite.py
// `_fwd_kernel` (reached through `_fwd_call`) and `_bwd_kernel` (through
// `_bwd_call`). The Pallas kernels turn the recurrence into triangular
// matmuls on the MXU with a per-chunk log-transmittance ladder; that is a
// TPU device, not part of the semantics, and is not carried over.
//
// Semantics (per 16x16 tile t, per pixel p, slots k in depth order):
//   power = -0.5 (A dx^2 + C dy^2) - B dx dy,  alpha = min(0.99, op e^power)
//   a slot contributes if power <= 0, alpha >= 1/255 and k < count[t];
//   it is included while T_excl (1 - alpha) >= 1e-4, with weight
//   w = alpha T_excl. out = sum w feat (+ z^2 from feature sq_col),
//   final_T = 1 - sum w.
// After the first contributing slot that fails the T rule, T_excl keeps
// falling, so no later slot can pass it: a pixel stops there.
//
// What bounds it on this card: the per-(slot, pixel) arithmetic. Each
// included pair costs one expf and ~20 f32 operations; the bytes (a tile's
// slot records, 40 B each, read once per block) are small by comparison.
// The design keeps every pair's work in registers:
//   * one block per tile, one thread per pixel (256 threads);
//   * the tile's slot records are staged in shared memory in batches, so
//     each record is read from device memory once and broadcast to all
//     256 pixels;
//   * a pixel stops at its termination slot and the block leaves as soon as
//     every pixel has stopped (__syncthreads_count), so saturated tiles do
//     no work for their back slots;
//   * the forward keeps, per pixel, the index of the last included slot and
//     the transmittance after it. The backward walks back to front from that
//     index, recovering T_excl = T / (1 - alpha) (alpha <= 0.99, so the
//     divisor is >= 0.01), with a running suffix sum_{j>k} g_w_j w_j.
//   * each slot belongs to one tile, so its gradient is a sum over that
//     tile's 256 pixels: a warp-shuffle reduction, then a shared-memory sum
//     over the 8 warps. No global atomics; every gradient row is written
//     once, in f32 or bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;      // pixels (threads) per tile
constexpr int NWARP = P / 32;
constexpr int FWD_BATCH = 128;      // slots staged per batch, forward
constexpr int BWD_BATCH = 32;       // slots staged per batch, backward
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int F>
__global__ void __launch_bounds__(P)
composite_fwd_kernel(const float* __restrict__ gdata,
                     const int* __restrict__ counts, int K, int sq_col,
                     int tiles_x, float* __restrict__ out,
                     float* __restrict__ final_t, int* __restrict__ last_out,
                     float* __restrict__ tend_out) {
  constexpr int C = 6 + F;
  __shared__ float sm[FWD_BATCH * C];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = (float)((t % tiles_x) * TILE + (p % TILE));
  const float py = (float)((t / tiles_x) * TILE + (p / TILE));
  const int count = min(counts[t], K);
  const float* g = gdata + (size_t)t * K * C;
  const bool has_sq = sq_col >= 0;

  float acc[F + 1];
#pragma unroll
  for (int f = 0; f <= F; ++f) acc[f] = 0.f;
  float T = 1.f, wsum = 0.f;
  int last = -1;
  bool done = false;

  for (int base = 0; base < count; base += FWD_BATCH) {
    const int nb = min(FWD_BATCH, count - base);
    __syncthreads();
    for (int i = p; i < nb * C; i += P) sm[i] = g[(size_t)base * C + i];
    __syncthreads();
    if (!done) {
      for (int j = 0; j < nb; ++j) {
        const float* s = sm + j * C;
        const float dx = s[0] - px;
        const float dy = s[1] - py;
        const float power = -0.5f * (s[2] * dx * dx + s[4] * dy * dy)
                            - s[3] * dx * dy;
        if (power > 0.f) continue;
        const float alpha = fminf(ALPHA_MAX, s[5] * expf(power));
        if (alpha < ALPHA_MIN) continue;
        const float one_m = 1.f - alpha;
        if (T * one_m < T_EPS) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += w * s[6 + f];
        if (has_sq) {
          const float z = s[6 + sq_col];
          acc[F] += w * (z * z);
        }
        wsum += w;
        T *= one_m;
        last = base + j;
      }
    }
    if (__syncthreads_count(!done) == 0) break;
  }

  const int Fo = F + (has_sq ? 1 : 0);
  const size_t pix = (size_t)t * P + p;
#pragma unroll
  for (int f = 0; f <= F; ++f)
    if (f < Fo) out[pix * Fo + f] = acc[f];
  final_t[pix] = 1.f - wsum;
  last_out[pix] = last;
  tend_out[pix] = T;
}

template <int F, typename OutT>
__global__ void __launch_bounds__(P)
composite_bwd_kernel(const float* __restrict__ gdata,
                     const int* __restrict__ counts, int K, int sq_col,
                     int tiles_x, const float* __restrict__ gout,
                     const float* __restrict__ dfinal,
                     const int* __restrict__ last_in,
                     const float* __restrict__ tend_in,
                     OutT* __restrict__ dg) {
  constexpr int C = 6 + F;
  __shared__ float slots[BWD_BATCH * C];
  __shared__ float part[NWARP][BWD_BATCH][C];
  __shared__ int smax;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = (float)((t % tiles_x) * TILE + (p % TILE));
  const float py = (float)((t / tiles_x) * TILE + (p / TILE));
  const bool has_sq = sq_col >= 0;
  const int Fo = F + (has_sq ? 1 : 0);
  const size_t pix = (size_t)t * P + p;

  const int my_last = last_in[pix];
  float T = tend_in[pix];
  const float gt = -dfinal[pix];   // final_T = 1 - sum w
  float go[F + 1];
#pragma unroll
  for (int f = 0; f <= F; ++f) go[f] = (f < Fo) ? gout[pix * Fo + f] : 0.f;

  if (p == 0) smax = -1;
  __syncthreads();
  atomicMax(&smax, my_last);
  __syncthreads();
  const int maxl = smax;
  (void)counts;

  OutT* d = dg + (size_t)t * K * C;
  // rows no pixel included (past every pixel's termination, or at/after
  // count) carry a zero gradient
  for (int i = (maxl + 1) * C + p; i < K * C; i += P) store(d + i, 0.f);

  float S = 0.f;   // sum_{j > k} g_w_j w_j
  for (int hi = maxl; hi >= 0; hi -= BWD_BATCH) {
    const int lo = max(0, hi - BWD_BATCH + 1);
    const int nb = hi - lo + 1;
    __syncthreads();
    for (int i = p; i < nb * C; i += P)
      slots[i] = gdata[((size_t)t * K + lo) * C + i];
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const int k = lo + j;
      const float* s = slots + j * C;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = 0.f;
      bool active = false;
      if (k <= my_last) {
        const float dx = s[0] - px;
        const float dy = s[1] - py;
        const float power = -0.5f * (s[2] * dx * dx + s[4] * dy * dy)
                            - s[3] * dx * dy;
        if (power <= 0.f) {
          const float e = expf(power);
          const float alpha = fminf(ALPHA_MAX, s[5] * e);
          if (alpha >= ALPHA_MIN) {
            // contributing and at or before this pixel's last included
            // slot: included
            active = true;
            const float one_m = 1.f - alpha;
            const float Tex = T / one_m;
            const float w = alpha * Tex;
            float gw = gt;
#pragma unroll
            for (int f = 0; f < F; ++f) gw += s[6 + f] * go[f];
            float zsq_go = 0.f;
            if (has_sq) {
              const float z = s[6 + sq_col];
              gw += (z * z) * go[F];
              zsq_go = 2.f * z * (w * go[F]);
            }
            const float da = gw * Tex - S / one_m;
            const float dalpha = (alpha < ALPHA_MAX) ? da : 0.f;
            const float dpower = dalpha * alpha;
            const float A = s[2], B = s[3], Cc = s[4];
            v[0] = (-A * dx - B * dy) * dpower;
            v[1] = (-Cc * dy - B * dx) * dpower;
            v[2] = -0.5f * dx * dx * dpower;
            v[3] = -dx * dy * dpower;
            v[4] = -0.5f * dy * dy * dpower;
            v[5] = dalpha * e;
#pragma unroll
            for (int f = 0; f < F; ++f) v[6 + f] = w * go[f];
            if (has_sq) {
#pragma unroll
              for (int f = 0; f < F; ++f)
                if (f == sq_col) v[6 + f] += zsq_go;
            }
            S += gw * w;
            T = Tex;
          }
        }
      }
      if (__any_sync(0xffffffffu, active)) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float x = v[c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, o);
          if (lane == 0) part[warp][j][c] = x;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) part[warp][j][c] = 0.f;
      }
    }
    __syncthreads();
    for (int i = p; i < nb * C; i += P) {
      const int j = i / C, c = i % C;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) x += part[w][j][c];
      store(d + (size_t)(lo + j) * C + c, x);
    }
  }
}

template <int F>
cudaError_t launch_fwd(const float* gdata, const int* counts, int T, int K,
                       int sq_col, int tiles_x, float* out, float* final_t,
                       int* last, float* tend, cudaStream_t stream) {
  composite_fwd_kernel<F><<<T, P, 0, stream>>>(
      gdata, counts, K, sq_col, tiles_x, out, final_t, last, tend);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd(const float* gdata, const int* counts, int T, int K,
                       int sq_col, int tiles_x, const float* gout,
                       const float* dfinal, const int* last,
                       const float* tend, int out_bf16, void* dg,
                       cudaStream_t stream) {
  if (out_bf16)
    composite_bwd_kernel<F, __nv_bfloat16><<<T, P, 0, stream>>>(
        gdata, counts, K, sq_col, tiles_x, gout, dfinal, last, tend,
        (__nv_bfloat16*)dg);
  else
    composite_bwd_kernel<F, float><<<T, P, 0, stream>>>(
        gdata, counts, K, sq_col, tiles_x, gout, dfinal, last, tend,
        (float*)dg);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). Each returns cudaGetLastError() of its
// launch; cudaErrorInvalidValue for an unsupported feature count.
extern "C" int composite_fwd(const float* gdata, const int* counts, int T,
                             int K, int F, int sq_col, int tiles_x,
                             float* out, float* final_t, int* last,
                             float* tend, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_fwd<1>(gdata, counts, T, K, sq_col, tiles_x, out,
                                 final_t, last, tend, s);
    case 2: return launch_fwd<2>(gdata, counts, T, K, sq_col, tiles_x, out,
                                 final_t, last, tend, s);
    case 3: return launch_fwd<3>(gdata, counts, T, K, sq_col, tiles_x, out,
                                 final_t, last, tend, s);
    case 4: return launch_fwd<4>(gdata, counts, T, K, sq_col, tiles_x, out,
                                 final_t, last, tend, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int composite_bwd(const float* gdata, const int* counts, int T,
                             int K, int F, int sq_col, int tiles_x,
                             const float* gout, const float* dfinal,
                             const int* last, const float* tend,
                             int out_bf16, void* dg, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_bwd<1>(gdata, counts, T, K, sq_col, tiles_x, gout,
                                 dfinal, last, tend, out_bf16, dg, s);
    case 2: return launch_bwd<2>(gdata, counts, T, K, sq_col, tiles_x, gout,
                                 dfinal, last, tend, out_bf16, dg, s);
    case 3: return launch_bwd<3>(gdata, counts, T, K, sq_col, tiles_x, gout,
                                 dfinal, last, tend, out_bf16, dg, s);
    case 4: return launch_bwd<4>(gdata, counts, T, K, sq_col, tiles_x, gout,
                                 dfinal, last, tend, out_bf16, dg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
