// Hash-grid K nearest neighbours for Hopper (sm_90a): kernel K.
//
// Replaces no TPU kernel: the JAX package leaves the query to XLA
// (isogs_slam_tpu/ops/spatial_hash.py `knn_hash`), which fuses it. PyTorch
// runs it eagerly (ops/spatial_hash.py `knn_hash_plain`, 65 launches): it
// lays out every query's 27 neighbour cells x `cap` bucket positions as
// [Q, 27 cap] tensors (the positions int64, the gathered points f32 x 3,
// their differences, the masks), 0.87 GiB at the iso pool's 32,768
// queries and cap 24, to keep 16 of them.
//
// Semantics (knn_hash_plain, in the same order of operations): the
// query's cell is floor(q / cell_size) per axis, in f32 with IEEE
// division, as int64; its 27 neighbour cells are cell + (dx, dy, dz) with
// each of dx, dy, dz in {-1, 0, 1}, dx slowest (meshgrid "ij" order); a
// cell's bucket is h = (cx P1 ^ cy P2 ^ cz P3) & (table_size - 1) in int64,
// and the candidates are the bucket's first `cap` positions s .. s + cap - 1
// of the hash-sorted rows. A position counts where it is below the
// bucket's end and its row's packed cell equals the neighbour cell's
// (10 bits an axis after clamp(c + 512, 0, 1023), so far cells alias);
// rows of other cells that share the bucket use positions up. The
// distance is d2 = (dx^2 + dz^2) + dy^2 with d = p - q, the order in which
// PyTorch's reduction on the card sums a row of 3 values (two threads, the
// first holding the 1st and 3rd); the file builds with -fmad=false, so the
// distances equal the eager chain's bit for bit. The output is the k
// smallest d2 in ascending order with the rows' original indices, in the
// order torch.topk(-d2, k) gives them on the card: it takes the
// candidates above the k-th value in candidate position order (neighbour
// index x cap + slot), then those equal to it in that order until it has
// k, and sorts those k with a 32-wide bitonic network (ATen's
// SortUtils.cuh bitonicSort under GTOp), which does not keep the order of
// equal keys. A map's rows tie often (replica.orbit's pools hold ~3,800
// tied neighbour pairs in a 32-frame job), and the order of tied
// neighbours reaches the loss through the order of the density's sum: in
// candidate order instead, replica.orbit's ate_cm read 0.2408 against
// 0.2065. Where fewer than k candidates count, the rest read d2 = +inf
// and name the rows topk names: the first positions that do not count,
// in candidate order, whose row is the sorted row at s + slot (0 past the
// last row). The loss masks those rows, but its backward adds a zero for
// each into that row's gradient, and ATen's sorted gather backward adds
// a row's entries one after another: one row named for every missing
// neighbour (~2,600 an iteration in tum.handheld) took 26.8 device ms a
// frame there.
//
// What bounds it on this card: latency. The queries are random rows of the
// map, so neighbouring queries share no cells; the buckets vary in length
// and most of the 27 cap positions fail the bucket or cell test; every
// candidate costs a chain of dependent loads (bucket range, then the row's
// cell, then its point). The grid itself (~23 MB at 524,288 rows) sits in
// the 50 MB L2. Design: a warp per query. Lane c < 27 forms neighbour cell
// c's hash and loads its bucket range and packed key at once, so the 27
// bucket lookups are one round trip. The warp then walks the cells in
// order, the lanes on consecutive positions of the bucket (a bucket's rows
// are contiguous, so their cells and points come in as one or two lines),
// and keeps the k best in registers across the warp, lane i holding the
// i-th: each counting candidate under the current k-th (in lane, that is
// position, order) is inserted by a ballot for its place and a shuffle of
// the tail up by one lane, after equal distances, so the k kept are
// topk's. Lane i also keeps the i-th position that does not count. Then
// the lanes take topk's arrangement (by shuffles: a rank by position for
// the rows above the k-th value) and run the same bitonic network on
// (-d2, position), a stage a shuffle. Only the [Q, k] outputs touch
// memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 32;
constexpr int NCELLS = 27;
constexpr unsigned FULL = 0xffffffffu;
constexpr int64_t P1 = 73856093, P2 = 19349663, P3 = 83492791;

__device__ __forceinline__ int64_t pack_axis(int64_t c) {
  return min(max(c + 512, (int64_t)0), (int64_t)1023);
}

// one compare-exchange stage of ATen's bitonicSort across the warp, lane p
// holding element p: the pair (p, p ^ stride), low element A, swapped as
// bitonicSwap does with GTOp (invalid entries sort to the end)
__device__ __forceinline__ void bitonic_stage(float& key, int& pos,
                                              bool& valid, int lane,
                                              int stride, bool dir) {
  const float pk = __shfl_xor_sync(FULL, key, stride);
  const int pp = __shfl_xor_sync(FULL, pos, stride);
  const bool pv = __shfl_xor_sync(FULL, (int)valid, stride) != 0;
  const bool low = (lane & stride) == 0;
  const float ka = low ? key : pk, kb = low ? pk : key;
  const bool va = low ? valid : pv, vb = low ? pv : valid;
  const bool swap = (ka > kb && va) || !vb;
  if (swap == dir) {
    key = pk;
    pos = pp;
    valid = pv;
  }
}

__global__ void __launch_bounds__(THREADS)
knn_hash_kernel(const float* __restrict__ queries, int Q,
                const float* __restrict__ points,
                const int64_t* __restrict__ order, int64_t C,
                const int64_t* __restrict__ cell_of,
                const int64_t* __restrict__ starts,
                const int64_t* __restrict__ ends,
                const float* __restrict__ cell_size, int64_t table_mask,
                int cap, int k, float* __restrict__ out_d,
                int64_t* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (qi >= Q) return;  // the whole warp: one query a warp
  const float cs = *cell_size;
  const float qx = queries[3 * (size_t)qi];
  const float qy = queries[3 * (size_t)qi + 1];
  const float qz = queries[3 * (size_t)qi + 2];
  const int64_t cx = (int64_t)floorf(qx / cs);
  const int64_t cy = (int64_t)floorf(qy / cs);
  const int64_t cz = (int64_t)floorf(qz / cs);
  // lane c < 27: neighbour cell c's bucket range and packed cell
  int64_t my_s = 0, my_e = 0, my_key = -1;
  if (lane < NCELLS) {
    const int64_t nx = cx + (lane / 9 - 1);
    const int64_t ny = cy + ((lane / 3) % 3 - 1);
    const int64_t nz = cz + (lane % 3 - 1);
    const int64_t h = ((nx * P1) ^ (ny * P2) ^ (nz * P3)) & table_mask;
    my_s = starts[h];
    my_e = ends[h];
    my_key = pack_axis(nx) | (pack_axis(ny) << 10) | (pack_axis(nz) << 20);
  }
  // lane i < k holds the i-th best by (d2, candidate position), lanes
  // from k on stay at +inf; and the i-th position that does not count
  // (`filled` of them so far, for the walk to stop at k)
  float best_d = INFINITY;
  int best_c = -1, miss_c = -1, filled = 0;
  for (int c = 0; c < NCELLS; ++c) {
    const int64_t s = __shfl_sync(FULL, my_s, c);
    const int64_t e = __shfl_sync(FULL, my_e, c);
    const int64_t key = __shfl_sync(FULL, my_key, c);
    const int64_t n = min((int64_t)cap, e - s);
    for (int j0 = 0; j0 < (filled < k ? (int64_t)cap : n); j0 += 32) {
      const int64_t pos = s + j0 + lane;
      float d2 = INFINITY;
      bool ok = j0 + lane < n && cell_of[pos] == key;
      if (filled < k) {
        unsigned miss = __ballot_sync(FULL, j0 + lane < cap && !ok);
        for (; miss && filled < k; ++filled) {
          if (lane == filled) miss_c = c * cap + j0 + __ffs(miss) - 1;
          miss &= miss - 1;
        }
      }
      if (ok) {
        const float dx = points[3 * pos] - qx;
        const float dy = points[3 * pos + 1] - qy;
        const float dz = points[3 * pos + 2] - qz;
        d2 = (dx * dx + dz * dz) + dy * dy;
      }
      const float worst = __shfl_sync(FULL, best_d, k - 1);
      unsigned todo = __ballot_sync(FULL, ok && d2 < worst);
      while (todo) {
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        const float cd = __shfl_sync(FULL, d2, l);
        // the k-th may have fallen below this candidate since the ballot
        if (!(cd < __shfl_sync(FULL, best_d, k - 1))) continue;
        // the list is ascending, so the lanes above cd are a tail from
        // `at`; cd goes after any equal distance (an earlier position)
        const int at = __ffs(__ballot_sync(FULL, lane < k && best_d > cd)) - 1;
        const float up_d = __shfl_up_sync(FULL, best_d, 1);
        const int up_c = __shfl_up_sync(FULL, best_c, 1);
        if (lane == at) {
          best_d = cd;
          best_c = c * cap + j0 + l;
        } else if (lane > at && lane < k) {
          best_d = up_d;
          best_c = up_c;
        }
      }
    }
  }
  // topk's arrangement: the nb rows above the k-th value by position (they
  // are lanes 0 .. nb-1, ascending by d2), then the rows equal to it, which
  // the lanes already hold by position
  const float kth = __shfl_sync(FULL, best_d, k - 1);
  const int nb = __popc(__ballot_sync(FULL, lane < k && best_d < kth));
  int rank = 0;
  for (int j = 0; j < nb; ++j) rank += __shfl_sync(FULL, best_c, j) < best_c;
  const int to = lane < nb ? rank : lane;
  int from = lane;
  for (int j = 0; j < k; ++j)
    if (__shfl_sync(FULL, to, j) == lane) from = j;
  float key = -__shfl_sync(FULL, best_d, from);
  int cand = __shfl_sync(FULL, best_c, from);
  // with fewer than k found (the k-th is +inf) the rest are the first
  // positions that do not count, in order
  const int m = __shfl_sync(FULL, miss_c, max(lane - nb, 0));
  if (lane < k && cand < 0) cand = m;
  bool valid = lane < k;
  // bitonicSort<32>: the merges of sizes 2-16, then the final one
#pragma unroll
  for (int size = 2; size < 32; size *= 2) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2)
      bitonic_stage(key, cand, valid, lane, stride,
                    ((lane & ~stride) & size) != 0);
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride /= 2)
    bitonic_stage(key, cand, valid, lane, stride, false);
  // the candidate's row: the sorted row at neighbour cell cand / cap's
  // bucket start + slot (0 past the last row)
  const int64_t at = __shfl_sync(FULL, my_s, cand >= 0 ? cand / cap : 0) +
                     (cand >= 0 ? cand % cap : 0);
  if (lane < k) {
    out_d[(size_t)qi * k + lane] = -key;
    out_i[(size_t)qi * k + lane] = cand >= 0 && at < C ? order[at] : 0;
  }
}

}  // namespace

// C interface (loaded with ctypes): returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for k outside 1..KMAX, cap < 1 or a
// table_size that is not a power of two. cell_size points at one float on
// the card (the grid's, so the launch reads nothing back to the host).
extern "C" int knn_hash(const float* queries, int Q, const float* points,
                        const int64_t* order, int64_t C,
                        const int64_t* cell_of,
                        const int64_t* starts, const int64_t* ends,
                        const float* cell_size, int64_t table_size, int cap,
                        int k, float* out_d, int64_t* out_i, void* stream) {
  if (k < 1 || k > KMAX || cap < 1 || table_size < 1 ||
      (table_size & (table_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const int blocks = (Q + WARPS - 1) / WARPS;
  knn_hash_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      queries, Q, points, order, C, cell_of, starts, ends, cell_size,
      table_size - 1, cap, k, out_d, out_i);
  return (int)cudaGetLastError();
}
