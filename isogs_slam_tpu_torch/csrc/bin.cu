// Tile binning for Hopper (sm_90a): kernel pair Q, the count (Q count) and
// the expansion into sort keys (Q expand).
//
// Replaces no TPU kernel: the JAX package bins with plain XLA
// (isogs_slam_tpu/ops/rasterize.py `bin_gaussians`), which fuses the
// expansion into a few passes. PyTorch runs it eagerly: each Gaussian's
// two tile rects are int64 tensors ([N, 2] four times, 64 B a row), and the
// rects and the expansion take ~100 launches, most over E-sized int64
// tensors (E = the number of (Gaussian, tile) pairs, up to the capacity M =
// 2.5-4 N).
//
// Semantics (ops/rasterize.py `_expand`, `tile_rects`, `_tile_rect`, in the
// same order of operations): a valid row's rect in tiles is x0 =
// clamp(floor((u - r) / 16), 0, tiles_x), x1 = clamp(floor((((u + r) + 16)
// - 1) / 16), 0, tiles_x) (y likewise), with r = radius + margin for the
// binning rect and r = radius for the margin-free one; its count is
// (x1 - x0) (y1 - y0), 0 where the row is not valid. Entry `local` of a row
// (x fastest) sits at offs[row] + local of the gaussian-major expansion and
// holds tile = (y0 + local / sx) tiles_x + x0 + local % sx; its key is
// (tile + tile_base) << db | margin bit (the tile lies outside the
// margin-free rect) << (db - 1) | qz[row], and its source row `row`.
// Entries at or past E = min(total, M) are not written. The file builds
// with -fmad=false and each operation rounds as PyTorch's one-operation
// kernels do, so the keys equal the eager chain's bit for bit.
//
// What bounds it on this card: bytes. Both read (u, v) from the table's
// 20-byte rows (the whole row comes in), the radius 4 B and valid 1 B; Q
// count writes the count 4 B, Q expand reads the offset 8 B and the depth
// key 4 B a row and writes 12 B an entry (the int64 key and the int32
// source). Design: every rect lives in registers, never in memory. Q count
// is one thread a row. Q expand gives a warp 32 rows: each lane loads its
// own row (neighbouring lanes on neighbouring rows) and forms its rects,
// then the warp walks the rows that have entries, the row's numbers
// broadcast by shuffles, the lanes striding over the row's local index, so
// a row's keys are written as one contiguous stretch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// PyTorch's clamp(floor(x), 0, hi) on the card, as the int64 cast takes it
// (the rows that reach it are valid, so x is not NaN)
__device__ __forceinline__ int tile_edge(float x, int hi) {
  return (int)fminf(fmaxf(floorf(x), 0.f), (float)hi);
}

struct Rect {
  int x0, y0, x1, y1;
};

__device__ __forceinline__ Rect tile_rect(float u, float v, float r,
                                          int tiles_x, int tiles_y) {
  Rect t;
  t.x0 = tile_edge((u - r) / 16.f, tiles_x);
  t.y0 = tile_edge((v - r) / 16.f, tiles_y);
  t.x1 = tile_edge((((u + r) + 16.f) - 1.f) / 16.f, tiles_x);
  t.y1 = tile_edge((((v + r) + 16.f) - 1.f) / 16.f, tiles_y);
  return t;
}

__device__ __forceinline__ int rect_count(const Rect& t) {
  return max(t.x1 - t.x0, 0) * max(t.y1 - t.y0, 0);
}

__global__ void __launch_bounds__(THREADS)
bin_count_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 int stride, const int* __restrict__ radius,
                 const uint8_t* __restrict__ valid, int N, float margin,
                 int tiles_x, int tiles_y, int* __restrict__ counts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  int c = 0;
  if (valid[i]) {
    const size_t k = (size_t)i * stride;
    c = rect_count(tile_rect(u[k], v[k], (float)radius[i] + margin, tiles_x,
                             tiles_y));
  }
  counts[i] = c;
}

__global__ void __launch_bounds__(THREADS)
bin_expand_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  int stride, const int* __restrict__ radius,
                  const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ offs,
                  const int* __restrict__ qz, int N, float margin,
                  int tiles_x, int tiles_y, int db, int64_t tile_base,
                  int64_t E, int64_t* __restrict__ keys,
                  int* __restrict__ src) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * THREADS + threadIdx.x) - lane;
  const int i = row0 + lane;
  // this lane's row: its binning rect, margin-free rect, offset and depth
  int cnt = 0, x0 = 0, y0 = 0, sx = 1, q = 0;
  Rect tr = {0, 0, 0, 0};
  int64_t off = 0;
  if (i < N && valid[i]) {
    const size_t k = (size_t)i * stride;
    const float ui = u[k], vi = v[k];
    const float rd = (float)radius[i];
    const Rect br = tile_rect(ui, vi, rd + margin, tiles_x, tiles_y);
    tr = tile_rect(ui, vi, rd, tiles_x, tiles_y);
    cnt = rect_count(br);
    x0 = br.x0;
    y0 = br.y0;
    sx = max(br.x1 - br.x0, 1);
    off = offs[i];
    q = qz[i];
  }
  unsigned todo = __ballot_sync(FULL, cnt > 0 && off < E);
  const int64_t mbit = (int64_t)1 << (db - 1);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const int n = __shfl_sync(FULL, cnt, l);
    const int64_t o = __shfl_sync(FULL, off, l);
    const int rx0 = __shfl_sync(FULL, x0, l);
    const int ry0 = __shfl_sync(FULL, y0, l);
    const int rsx = __shfl_sync(FULL, sx, l);
    const int tx0 = __shfl_sync(FULL, tr.x0, l);
    const int ty0 = __shfl_sync(FULL, tr.y0, l);
    const int tx1 = __shfl_sync(FULL, tr.x1, l);
    const int ty1 = __shfl_sync(FULL, tr.y1, l);
    const int64_t rq = (int64_t)__shfl_sync(FULL, q, l);
    const int last = (int)min((int64_t)n, E - o);
    for (int local = lane; local < last; local += 32) {
      const int tx = rx0 + local % rsx;
      const int ty = ry0 + local / rsx;
      const bool in_true = tx >= tx0 && ty >= ty0 && tx < tx1 && ty < ty1;
      const int64_t tile = (int64_t)ty * tiles_x + tx + tile_base;
      keys[o + local] = (tile << db) | (in_true ? 0 : mbit) | rq;
      src[o + local] = row0 + l;
    }
  }
}

}  // namespace

// C interface (loaded with ctypes): each returns cudaGetLastError() of its
// launch. u and v are columns of one table (`stride` floats between rows).
extern "C" int bin_count(const float* u, const float* v, int stride,
                         const int* radius, const void* valid, int N,
                         float margin, int tiles_x, int tiles_y, int* counts,
                         void* stream) {
  if (N == 0) return 0;
  const int blocks = (N + THREADS - 1) / THREADS;
  bin_count_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      u, v, stride, radius, (const uint8_t*)valid, N, margin, tiles_x,
      tiles_y, counts);
  return (int)cudaGetLastError();
}

extern "C" int bin_expand(const float* u, const float* v, int stride,
                          const int* radius, const void* valid,
                          const int64_t* offs, const int* qz, int N,
                          float margin, int tiles_x, int tiles_y, int db,
                          int64_t tile_base, int64_t E, int64_t* keys,
                          int* src, void* stream) {
  if (N == 0 || E == 0) return 0;
  const int blocks = (N + THREADS - 1) / THREADS;
  bin_expand_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      u, v, stride, radius, (const uint8_t*)valid, offs, qz, N, margin,
      tiles_x, tiles_y, db, tile_base, E, keys, src);
  return (int)cudaGetLastError();
}
