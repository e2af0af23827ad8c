// Per-tile front-to-back alpha compositing for Hopper (sm_90a): forward and
// backward.
//
// Replaces the TPU kernels isogs_slam_tpu/ops/pallas_composite.py
// `_fwd_kernel` (reached through `_fwd_call`) and `_bwd_kernel` (through
// `_bwd_call`). The Pallas kernels turn the recurrence into triangular
// matmuls on the MXU with a per-chunk log-transmittance ladder; that is a
// TPU device, not part of the semantics, and is not carried over. What is
// carried over is the shape of the backward's reduction: the sum over a
// tile's pixels is a small matrix product (phase 2 below).
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
// What bounds both kernels on this card: the instruction rate. The bytes (a
// tile's slot records, 40 B each, read once per block) are small. At
// 1200x680 a slot is included by about 20 of its tile's 256 pixels (one
// (slot, pixel) pair in twelve), so what counts is how cheaply the other
// pairs are passed over and how full the lanes are on the ones that count.
// The design, common to both kernels:
//   * one block per tile; each of its 8 warps owns an 8x4 block of pixels,
//     one pixel per lane;
//   * slot records are staged in shared memory 32 at a time, re-laid as
//     three 16-byte words (u, v, -A/2, B | -C/2, pmin, op, z^2 | features);
//     the next batch's records are fetched into registers before this
//     batch's walk and stored after it (they are transformed on the way,
//     so the copy goes through registers rather than cp.async);
//   * block cull: lane j tests slot j of the batch against the warp's 8x4
//     block (the largest `power` over the block against pmin), and one
//     ballot gives the slots the warp has to walk: one in four;
//   * phase 1a: the warp walks those slots together, without branches: 12
//     operations of `power` per lane and one compare against
//     pmin = log(1/255 / op) - margin, which rejects without an
//     exponential. Each lane keeps a bit mask of its candidates;
//   * phase 1b: each lane walks its own candidates, so the lanes work on
//     different slots at once and the exponential, the blend and the
//     gradient arithmetic run about 6 times per warp and batch instead of
//     once for every slot some lane includes. Candidates inside the margin
//     band are tested on alpha >= 1/255 exactly as the plain version does,
//     so every threshold decision is unchanged. Halving A and C is exact,
//     so `power` rounds as in the plain version;
//   * the file builds with -fmad=false, which keeps `power` and the
//     threshold products unfused; accumulations that cannot move a
//     threshold use explicit fmaf. (Contracting the whole file measured
//     1-2% faster and moved the forward's largest error from 7e-7 to
//     1.7e-6.)
// Forward: a pixel stops at its termination slot and the block leaves as
// soon as every pixel has stopped (__syncthreads_count). It keeps, per
// pixel, the index of the last included slot and the transmittance after
// it.
// Backward: walks back to front from that index, recovering
// T_excl = T / (1 - alpha) (alpha <= 0.99, so the divisor is >= 0.01), with
// a running suffix sum_{j>k} g_w_j w_j. Only two per-pair scalars depend on
// both slot and pixel: dpower and w. Per batch of 32 slots,
//   phase 1: as above; the slots that pass a warp's cull get one of the
//            warp's 16 cells each (in rounds, if more than 16 pass), and
//            phase 1b stores (dpower, w) to the slot's cell as
//            [cell][lane];
//   phase 2: each warp forms, for each of its cells with an included pair,
//            11 sums over its 32 pixels: M_m = sum dpower phi_m,
//            phi = (1, x, y, x^2, xy, y^2) in tile-local coordinates
//            (|x|, |y| <= 7.5 about the tile centre, so re-expanding
//            (u - px)^2 does not cancel at u ~ 1200), and
//            G_f = sum w gout_f. A lane owns half a cell (16 pixels, ~14
//            instructions each, f32 FMAs) and one shuffle joins the halves;
//   phase 3: after a block barrier the first warp adds the eight blocks'
//            sums of each slot and composes the ten columns: du, dv, dA,
//            dB, dC from M and the slot's centre and conic, dop = M_0 / op
//            (dalpha e = dpower / op where the clamp is inactive, and
//            dpower = 0 where it is active), dfeat = G (+ 2 z G_zz into the
//            z column).
// No atomics on gradients; every gradient row is written once, in f32 or
// bf16; rows past every pixel's last included slot are written as zeros.
// An earlier version reduced each slot's ten columns with a warp-shuffle
// tree per slot per warp (about 100 shuffle/add instructions per slot per
// warp on top of the pair arithmetic), which was what bounded it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;      // pixels (threads) per tile
constexpr int NWARP = P / 32;
constexpr int BW = 8, BH = 4;       // a warp's block of pixels
constexpr int FWD_BATCH = 32;       // slots staged per batch, forward
constexpr int BWD_BATCH = 32;       // slots per batch, backward
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
// slack of the exp-free reject test, in units of `power`: far above the
// rounding of logf, the division and expf (~1e-6), far below the width of
// the band that matters (log 255 ~ 5.5)
constexpr float PMIN_MARGIN = 1e-3f;
// slack of the block cull per unit of the largest |term| of `power` in the
// block: ~100 f32 roundings
constexpr float CULL_REL = 1e-5f;
constexpr int REC = 3;              // float4 words per staged record
constexpr int NM = 11;              // block sums per slot: 6 moments + 5 G

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int F>
__device__ __forceinline__ void load_record(const float* __restrict__ g,
                                            float (&r)[6 + F]) {
#pragma unroll
  for (int c = 0; c < 6 + F; ++c) r[c] = __ldg(g + c);
}

// (u, v, -A/2, B | -C/2, pmin, op, z^2 | features, zero padded); z is
// feature sq_col, and z^2 is 0 without one
template <int F>
__device__ __forceinline__ void store_record(float4* dst,
                                             const float (&r)[6 + F],
                                             int sq_col) {
  float f[4] = {0.f, 0.f, 0.f, 0.f};
  float z = 0.f;
#pragma unroll
  for (int c = 0; c < F; ++c) {
    f[c] = r[6 + c];
    if (c == sq_col) z = r[6 + c];
  }
  dst[0] = make_float4(r[0], r[1], -0.5f * r[2], r[3]);
  // op <= 0 gives +inf or NaN: `power >= pmin` is then false for every pair
  dst[1] = make_float4(-0.5f * r[4], logf(ALPHA_MIN / r[5]) - PMIN_MARGIN,
                       r[5], z * z);
  dst[2] = make_float4(f[0], f[1], f[2], f[3]);
}

// -0.5 (A dx^2 + C dy^2) - B dx dy, in the plain version's rounding
__device__ __forceinline__ float pair_power(float hA, float B, float hC,
                                            float dx, float dy) {
  return (hA * dx * dx + hC * dy * dy) - B * dx * dy;
}

// Can the slot contribute to any pixel of the block [x0, x0 + BW - 1] x
// [y0, y0 + BH - 1]? Conservative: the largest `power` over the (continuous)
// block against pmin, with slack for rounding. `power` is concave with its
// top (0) at the slot's centre, so over the block it is largest at the
// centre if that is inside, else on an edge that faces the centre: the
// edge dx = ex or the edge dy = ey, (ex, ey) the block's point nearest the
// centre, at the edge's own top clamped to the edge. A conic that is not
// positive definite passes.
__device__ __forceinline__ bool block_may_contribute(const float4& a,
                                                     const float4& b,
                                                     float x0, float y0) {
  const float hA = a.z, B = a.w, hC = b.x;
  if (!(hA < 0.f && hC < 0.f && B * B < 4.f * hA * hC)) return true;
  const float dx0 = a.x - (x0 + (float)(BW - 1)), dx1 = a.x - x0;
  const float dy0 = a.y - (y0 + (float)(BH - 1)), dy1 = a.y - y0;
  const float ex = fminf(fmaxf(0.f, dx0), dx1);
  const float ey = fminf(fmaxf(0.f, dy0), dy1);
  // on dx = ex the top is at dy = (B / 2 hC) ex; on dy = ey at
  // dx = (B / 2 hA) ey
  const float ty = fminf(fmaxf(__fdividef(0.5f * B, hC) * ex, dy0), dy1);
  const float tx = fminf(fmaxf(__fdividef(0.5f * B, hA) * ey, dx0), dx1);
  const float m = fmaxf(pair_power(hA, B, hC, ex, ty),
                        pair_power(hA, B, hC, tx, ey));
  const float mx = fmaxf(dx0 * dx0, dx1 * dx1);
  const float my = fmaxf(dy0 * dy0, dy1 * dy1);
  const float mag = -(hA * mx + hC * my);
  return m >= b.y - CULL_REL * mag;
}

// thread -> pixel: warp w owns the BW x BH block at (8 (w & 1), 4 (w >> 1))
struct Pixel {
  int id;           // y * 16 + x within the tile
  float bx, by;     // the warp's block origin, absolute pixels
  float px, py;     // this thread's pixel, absolute
};
__device__ __forceinline__ Pixel thread_pixel(int t, int tiles_x, int p) {
  const int w = p >> 5, lane = p & 31;
  const int bx = BW * (w & 1), by = BH * (w >> 1);
  const int x = bx + (lane & (BW - 1)), y = by + lane / BW;
  const int ox = (t % tiles_x) * TILE, oy = (t / tiles_x) * TILE;
  Pixel q;
  q.id = y * TILE + x;
  q.bx = (float)(ox + bx);
  q.by = (float)(oy + by);
  q.px = (float)(ox + x);
  q.py = (float)(oy + y);
  return q;
}

template <int F>
__global__ void __launch_bounds__(P)
composite_fwd_kernel(const float* __restrict__ gdata,
                     const int* __restrict__ counts, int K, int sq_col,
                     int tiles_x, float* __restrict__ out,
                     float* __restrict__ final_t, int* __restrict__ last_out,
                     float* __restrict__ tend_out) {
  constexpr int C = 6 + F;
  __shared__ float4 rec[2][FWD_BATCH * REC];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const Pixel q = thread_pixel(t, tiles_x, p);
  const int count = min(counts[t], K);
  const float* g = gdata + (size_t)t * K * C;
  const bool has_sq = sq_col >= 0;

  float acc[F + 1];
#pragma unroll
  for (int f = 0; f <= F; ++f) acc[f] = 0.f;
  float T = 1.f, wsum = 0.f;
  int last = -1;
  bool done = false;
  float r[C];

  if (p < min(FWD_BATCH, count)) {
    load_record<F>(g + (size_t)p * C, r);
    store_record<F>(&rec[0][p * REC], r, sq_col);
  }
  __syncthreads();
  for (int base = 0, buf = 0; base < count; base += FWD_BATCH, buf ^= 1) {
    const int nb = min(FWD_BATCH, count - base);
    const bool fetch = p < min(FWD_BATCH, count - base - FWD_BATCH);
    if (fetch) load_record<F>(g + (size_t)(base + FWD_BATCH + p) * C, r);
    for (int h = 0; h < nb && __any_sync(FULL, !done); h += 32) {
      const float4* s = rec[buf] + h * REC;
      // lane j tests slot h + j of the batch against the warp's block
      unsigned m = __ballot_sync(
          FULL, h + lane < nb && block_may_contribute(s[lane * REC],
                                                      s[lane * REC + 1],
                                                      q.bx, q.by));
      // the warp walks the slots that passed, together and without
      // branches: each lane notes the ones its pixel may include
      unsigned cand = 0;
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const float4 a = s[j * REC];
        const float4 b = s[j * REC + 1];
        const float power = pair_power(a.z, a.w, b.x, a.x - q.px,
                                       a.y - q.py);
        if (power <= 0.f && power >= b.y) cand |= 1u << j;
      }
      // each lane blends its own candidates, front to back: the lanes
      // work on different slots at once
      while (cand && !done) {
        const int j = __ffs(cand) - 1;
        cand &= cand - 1;
        const float4 a = s[j * REC];
        const float4 b = s[j * REC + 1];
        const float power = pair_power(a.z, a.w, b.x, a.x - q.px,
                                       a.y - q.py);
        const float alpha = fminf(ALPHA_MAX, b.z * expf(power));
        if (alpha < ALPHA_MIN) continue;
        const float one_m = 1.f - alpha;
        if (T * one_m < T_EPS) {
          done = true;
          break;
        }
        const float w = alpha * T;
        const float4 fv = s[j * REC + 2];
        const float feat[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = fmaf(w, feat[f], acc[f]);
        acc[F] = fmaf(w, b.w, acc[F]);       // the z^2 channel
        wsum += w;
        T *= one_m;
        last = base + h + j;
      }
    }
    if (fetch) store_record<F>(&rec[buf ^ 1][p * REC], r, sq_col);
    if (__syncthreads_count(!done) == 0) break;
  }

  const int Fo = F + (has_sq ? 1 : 0);
  const size_t pix = (size_t)t * P + q.id;
#pragma unroll
  for (int f = 0; f <= F; ++f)
    if (f < Fo) out[pix * Fo + f] = acc[f];
  final_t[pix] = 1.f - wsum;
  last_out[pix] = last;
  tend_out[pix] = T;
}

// Shared memory of the backward, sized so that four blocks fit on an SM.
// A cell holds the 32 (dpower, w) values of one (warp's block of pixels,
// slot) pair in lane order; a warp has 16 cells, which it hands to the
// slots of the batch that pass its cull (in rounds, if more than 16 do).
// The odd cell stride lets phase 1 (a warp writes one cell) and phase 2
// (lanes read 16 neighbouring cells) both run without bank conflicts.
constexpr int WCELLS = 16;
constexpr int CELL_STRIDE = 33;     // float2
struct BwdShared {
  float4 rec[BWD_BATCH * REC];
  float4 gos[P * 2 + P / 16];       // gout per thread, 8 floats, see go_at
  float2 pw[NWARP * WCELLS * CELL_STRIDE];        // (dpower, w)
  float part[NWARP * BWD_BATCH * NM];             // sums per (block, slot)
  unsigned active[NWARP];           // per block: slots with an included pair
  int smax;
};
// one 16-byte word of padding every 16 pixels: the two halves of a warp
// read their gout words from different banks
__device__ __forceinline__ int go_at(int p) { return p * 2 + (p >> 4); }

template <int F, typename OutT>
__global__ void __launch_bounds__(P)
composite_bwd_kernel(const float* __restrict__ gdata, int K, int sq_col,
                     int tiles_x, const float* __restrict__ gout,
                     const float* __restrict__ dfinal,
                     const int* __restrict__ last_in,
                     const float* __restrict__ tend_in,
                     OutT* __restrict__ dg) {
  constexpr int C = 6 + F;
  constexpr int BB = BWD_BATCH;
  extern __shared__ float4 smem_raw[];
  BwdShared& sh = *reinterpret_cast<BwdShared*>(smem_raw);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const Pixel q = thread_pixel(t, tiles_x, p);
  const bool has_sq = sq_col >= 0;
  const int Fo = F + (has_sq ? 1 : 0);
  const size_t pix = (size_t)t * P + q.id;

  const int my_last = last_in[pix];
  float T = tend_in[pix];
  const float gt = -dfinal[pix];   // final_T = 1 - sum w
  float go[F + 1];
#pragma unroll
  for (int f = 0; f <= F; ++f) go[f] = (f < Fo) ? gout[pix * Fo + f] : 0.f;
  {
    float g5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int f = 0; f <= F; ++f) g5[f] = go[f];
    sh.gos[go_at(p)] = make_float4(g5[0], g5[1], g5[2], g5[3]);
    sh.gos[go_at(p) + 1] = make_float4(g5[4], 0.f, 0.f, 0.f);
  }
  const int warp_last = __reduce_max_sync(FULL, my_last);

  if (p == 0) sh.smax = -1;
  __syncthreads();
  if (lane == 0 && warp_last >= 0) atomicMax(&sh.smax, warp_last);
  __syncthreads();
  const int maxl = sh.smax;

  const float* g = gdata + (size_t)t * K * C;
  OutT* d = dg + (size_t)t * K * C;
  // rows no pixel included (past every pixel's termination, or at/after
  // count) carry a zero gradient
  for (int i = (maxl + 1) * C + p; i < K * C; i += P) store(d + i, 0.f);
  if (maxl < 0) return;

  float r[C];
  int lo = (maxl / BB) * BB;
  if (p < min(BB, maxl + 1 - lo)) {
    load_record<F>(g + (size_t)(lo + p) * C, r);
    store_record<F>(&sh.rec[p * REC], r, sq_col);
  }
  __syncthreads();

  // phase 2's cell of this lane: cell cc of the warp, half ch of its pixels
  // (rows 2 ch and 2 ch + 1 of the block)
  const int cc = lane & (WCELLS - 1);
  const int ch = lane >> 4;
  // tile-local coordinates of that half's first pixel
  const float X0 = (float)(BW * (warp & 1)) - 7.5f;
  const float Y0 = (float)(BH * (warp >> 1) + 2 * ch) - 7.5f;
  float2* const pw_w = sh.pw + warp * WCELLS * CELL_STRIDE;
  const float4* const s = sh.rec;

  float S = 0.f;   // sum_{j > k} g_w_j w_j
  for (; lo >= 0; lo -= BB) {
    const int nb = min(BB, maxl + 1 - lo);
    const bool fetch = lo > 0 && p < BB;      // the next batch is full
    if (fetch) load_record<F>(g + (size_t)(lo - BB + p) * C, r);

    // lane j tests slot j of the batch against the warp's block
    unsigned rest = __ballot_sync(
        FULL, lane < nb && lo + lane <= warp_last &&
                  block_may_contribute(s[lane * REC], s[lane * REC + 1],
                                       q.bx, q.by));
    const int rel_last = my_last - lo;
    unsigned act = 0;
    while (rest) {
      // this round: the (at most 16) highest slots that remain; cell c of
      // the warp takes the c-th highest
      unsigned round = rest;
      while (__popc(round) > WCELLS) round &= round - 1;
      rest &= ~round;

      // phase 1a: the warp walks the round's slots together and without
      // branches; each lane notes the ones its pixel may include
      unsigned cand = 0;
      int cslot = 0;                  // the slot of cell cc
      {
        unsigned m = round;
        float2* cell = pw_w + lane;
        for (int c = 0; m; ++c, cell += CELL_STRIDE) {
          const int j = 31 - __clz(m);
          m &= ~(1u << j);
          const float4 a = s[j * REC];
          const float4 b = s[j * REC + 1];
          const float power = pair_power(a.z, a.w, b.x, a.x - q.px,
                                         a.y - q.py);
          *cell = make_float2(0.f, 0.f);
          if (c == cc) cslot = j;
          if (power <= 0.f && power >= b.y && j <= rel_last) cand |= 1u << j;
        }
      }
      // phase 1b: each lane walks its own candidates back to front (the
      // lanes work on different slots at once)
      unsigned mine = 0;
      while (cand) {
        const int j = 31 - __clz(cand);
        cand &= ~(1u << j);
        const float4 a = s[j * REC];
        const float4 b = s[j * REC + 1];
        const float power = pair_power(a.z, a.w, b.x, a.x - q.px,
                                       a.y - q.py);
        const float alpha = fminf(ALPHA_MAX, b.z * expf(power));
        if (alpha < ALPHA_MIN) continue;
        // contributing and at or before this pixel's last included slot:
        // included
        const float4 fv = s[j * REC + 2];
        const float feat[4] = {fv.x, fv.y, fv.z, fv.w};
        const float inv = __fdividef(1.f, 1.f - alpha);
        const float Tex = T * inv;
        const float w = alpha * Tex;
        float gw = fmaf(b.w, go[F], gt);      // z^2 channel (go[F] = 0 if none)
#pragma unroll
        for (int f = 0; f < F; ++f) gw = fmaf(feat[f], go[f], gw);
        const float da = fmaf(gw, Tex, -S * inv);
        // (dpower, w) into the slot's cell: the slots of the round above j;
        // the clamp at 0.99 has no gradient
        const int c = __popc(round >> j) - 1;
        pw_w[c * CELL_STRIDE + lane] =
            make_float2((alpha < ALPHA_MAX) ? da * alpha : 0.f, w);
        S = fmaf(gw, w, S);
        T = Tex;
        mine |= 1u << j;
      }
      mine = __reduce_or_sync(FULL, mine);
      act |= mine;
      __syncwarp();

      // phase 2: the warp's own cells, 16 cells x 2 halves over the lanes
      float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f, m5 = 0.f;
      float gs[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      const bool on = cc < __popc(round) && ((mine >> cslot) & 1u);
      if (on) {
        const float2* row = pw_w + cc * CELL_STRIDE + ch * 16;
        const float4* gr = sh.gos + go_at(warp * 32 + ch * 16);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float r0 = 0.f, r1 = 0.f, r2 = 0.f;
#pragma unroll
          for (int x = 0; x < BW; ++x) {
            const int i = rr * BW + x;
            const float2 v = row[i];
            const float4 ga = gr[i * 2];
            const float gb = gr[i * 2 + 1].x;
            r0 += v.x;
            r1 = fmaf(v.x, (float)x, r1);
            r2 = fmaf(v.x, (float)(x * x), r2);
            gs[0] = fmaf(v.y, ga.x, gs[0]);
            gs[1] = fmaf(v.y, ga.y, gs[1]);
            gs[2] = fmaf(v.y, ga.z, gs[2]);
            gs[3] = fmaf(v.y, ga.w, gs[3]);
            gs[4] = fmaf(v.y, gb, gs[4]);
          }
          // x = X0 + x', y = Y0 + rr
          const float sx = fmaf(X0, r0, r1);
          const float sxx = fmaf(X0, fmaf(X0, r0, 2.f * r1), r2);
          const float yl = Y0 + (float)rr;
          m0 += r0;
          m1 += sx;
          m3 += sxx;
          m2 = fmaf(yl, r0, m2);
          m4 = fmaf(yl, sx, m4);
          m5 = fmaf(yl * yl, r0, m5);
        }
      }
      float o[NM] = {m0, m1, m2, m3, m4, m5, gs[0], gs[1], gs[2], gs[3],
                     gs[4]};
#pragma unroll
      for (int i = 0; i < NM; ++i) o[i] += __shfl_xor_sync(FULL, o[i], 16);
      if (on && ch == 0) {
        float* dst = sh.part + (warp * BB + cslot) * NM;
#pragma unroll
        for (int i = 0; i < NM; ++i) dst[i] = o[i];
      }
    }
    if (lane == 0) sh.active[warp] = act;
    __syncthreads();

    // phase 3 (the first warp): add the blocks' sums and compose each
    // slot's ten columns
    if (p < nb) {
      float m[NM];
#pragma unroll
      for (int i = 0; i < NM; ++i) m[i] = 0.f;
      for (int w = 0; w < NWARP; ++w) {
        if (!((sh.active[w] >> p) & 1u)) continue;
        const float* c = sh.part + (w * BB + p) * NM;
#pragma unroll
        for (int i = 0; i < NM; ++i) m[i] += c[i];
      }
      const float4 a = s[p * REC];
      const float4 b = s[p * REC + 1];
      const float4 fv = s[p * REC + 2];
      const float feat[4] = {fv.x, fv.y, fv.z, fv.w};
      const float A = -2.f * a.z, B = a.w, Cc = -2.f * b.x, op = b.z;
      // the slot's centre from the tile's centre: dx = ut - x, dy = vt - y
      const float ut = (a.x - (float)((t % tiles_x) * TILE)) - 7.5f;
      const float vt = (a.y - (float)((t / tiles_x) * TILE)) - 7.5f;
      const float sdx = fmaf(ut, m[0], -m[1]);            // sum dpower dx
      const float sdy = fmaf(vt, m[0], -m[2]);            // sum dpower dy
      const float sxx = fmaf(ut, sdx - m[1], m[3]);       // sum dpower dx^2
      const float syy = fmaf(vt, sdy - m[2], m[5]);       // sum dpower dy^2
      const float sxy = fmaf(ut, sdy, fmaf(-vt, m[1], m[4]));
      float v[C];
      v[0] = -A * sdx - B * sdy;
      v[1] = -Cc * sdy - B * sdx;
      v[2] = -0.5f * sxx;
      v[3] = -sxy;
      v[4] = -0.5f * syy;
      v[5] = (op > 0.f) ? m[0] / op : 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[6 + f] = m[6 + f];
        // the z^2 cotangent folds into z
        if (f == sq_col) v[6 + f] = fmaf(2.f * feat[f], m[6 + F], v[6 + f]);
      }
      OutT* dr = d + (size_t)(lo + p) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) store(dr + c, v[c]);
    }
    // the first warp read the records last: it stages the next batch's
    __syncwarp();
    if (fetch) store_record<F>(&sh.rec[p * REC], r, sq_col);
    __syncthreads();
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

template <int F, typename OutT>
cudaError_t launch_bwd_as(const float* gdata, int T, int K, int sq_col,
                          int tiles_x, const float* gout,
                          const float* dfinal, const int* last,
                          const float* tend, void* dg, cudaStream_t stream) {
  auto kernel = composite_bwd_kernel<F, OutT>;
  constexpr int bytes = (int)sizeof(BwdShared);
  static bool raised = false;     // above 48 KB shared memory is opt-in
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  kernel<<<T, P, bytes, stream>>>(gdata, K, sq_col, tiles_x, gout, dfinal,
                                  last, tend, (OutT*)dg);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd(const float* gdata, int T, int K, int sq_col,
                       int tiles_x, const float* gout, const float* dfinal,
                       const int* last, const float* tend, int out_bf16,
                       void* dg, cudaStream_t stream) {
  if (out_bf16)
    return launch_bwd_as<F, __nv_bfloat16>(gdata, T, K, sq_col, tiles_x,
                                           gout, dfinal, last, tend, dg,
                                           stream);
  return launch_bwd_as<F, float>(gdata, T, K, sq_col, tiles_x, gout, dfinal,
                                 last, tend, dg, stream);
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

// `counts` is not read: the forward's `last` already stops at each tile's
// count.
extern "C" int composite_bwd(const float* gdata, const int* counts, int T,
                             int K, int F, int sq_col, int tiles_x,
                             const float* gout, const float* dfinal,
                             const int* last, const float* tend,
                             int out_bf16, void* dg, void* stream) {
  (void)counts;
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_bwd<1>(gdata, T, K, sq_col, tiles_x, gout, dfinal,
                                 last, tend, out_bf16, dg, s);
    case 2: return launch_bwd<2>(gdata, T, K, sq_col, tiles_x, gout, dfinal,
                                 last, tend, out_bf16, dg, s);
    case 3: return launch_bwd<3>(gdata, T, K, sq_col, tiles_x, gout, dfinal,
                                 last, tend, out_bf16, dg, s);
    case 4: return launch_bwd<4>(gdata, T, K, sq_col, tiles_x, gout, dfinal,
                                 last, tend, out_bf16, dg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
