// EWA projection of camera-frame Gaussians into the compositing table, for
// Hopper (sm_90a): forward (P fwd) and backward (P bwd).
//
// Replaces no TPU kernel: the JAX package projects with plain XLA
// (isogs_slam_tpu/ops/rasterize.py `_ewa_core`, reached through
// `project_gaussians`, and the table stack of the render core), which fuses
// the ~80 elementwise operations into a few passes. PyTorch runs them
// eagerly: each operation is a launch over the map's capacity, and autograd
// keeps ~340 bytes a row of intermediates from the forward to the backward.
//
// Semantics, per row (ops/rasterize.py `_ewa_core` + `project_gaussians` +
// `_raster_table`, in the same order of operations): u = fx tx / (tz + 1e-7)
// + cx (+ offset), the 3D covariance R diag(e^2s) R^T from the normalised
// quaternion, the Jacobian with tx/tz and ty/tz clamped to 1.3 tanfov (tz
// = 0 guarded to 1e-7), the 2D covariance + 0.3, conic = adj / det with
// det = 0 guarded to 1, radius = ceil(3 sqrt(lambda1)) with the
// discriminant clamped at 0.1; valid = alive, tz > 0.2, det != 0, a
// non-empty tile rect (widened by the binning margin) and radius > 0. The
// table row is (u, v, A, B, C, sigmoid(logit) [0 where invalid when the
// binning is frozen], features, [tz]).
//
// What bounds it on this card: bytes. A row reads 44 B (+ features) and
// writes 45 B forward; the backward reads the inputs and the table's
// cotangent and writes the inputs' gradients, ~160 B a row: ~0.04 ms and
// ~0.06 ms at 1.25M rows. The design: one thread a row, one pass; every
// intermediate lives in registers; the backward recomputes the forward's
// intermediates instead of reading them, so autograd keeps only the inputs.
// The forward stages its table rows (20-44 bytes) in shared memory and
// writes them as one contiguous stretch: a thread's own row stores took
// 2.3x as long. The backward's loads and stores stay a thread's own: the
// same staging there (71 registers and four barriers) made it 1.4x
// slower.
// The file builds with -fmad=false, and each operation rounds as PyTorch's
// one-operation kernels do (the quaternion's squared norm is summed as
// PyTorch's reduction over 4 values sums it, (q0^2 + q2^2) + (q1^2 + q3^2)),
// so the forward equals the eager chain bit for bit. The backward follows
// autograd's conventions at the chain's kinks: clamp passes the gradient
// at its bounds, where() routes it, ceil and the radius carry none. It
// forms the covariance's gradient through M = J R (see below), whose sums
// cancel less than autograd's through the six entries of S: on thin
// footprints it rounds closer to a float64 evaluation than autograd does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CMAX = 16;   // widest table row: 6 + 9 features + depth

struct Cam {
  float fx, fy, cx, cy, neg_fx, neg_fy, limx, limy;
};

// PyTorch's clamp on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// The forward's intermediates of one row.
struct Ewa {
  float tz_safe, nrm, q[4], qn[4], R[9], s[3], var[3];
  float s00, s01, s02, s11, s12, s22;
  float tz_nz, xr, yr, txc, tyc, inv_z, inv_z2, j00, j02, j11, j12;
  float r0x, r0z, r1y, r1z, t01, c00, c01, c11, det, det_safe;
  float u, v, cA, cB, cC, radius_f;
};

__device__ __forceinline__ void ewa(const float* m, const float* q4,
                                    const float* ls, const Cam& c, Ewa& e) {
  const float tx = m[0], ty = m[1], tz = m[2];
  e.tz_safe = tz + (float)1e-7;
  e.u = (tx * c.fx) / e.tz_safe + c.cx;
  e.v = (ty * c.fy) / e.tz_safe + c.cy;

  for (int i = 0; i < 4; ++i) e.q[i] = q4[i];
  const float ss = (e.q[0] * e.q[0] + e.q[2] * e.q[2])
                   + (e.q[1] * e.q[1] + e.q[3] * e.q[3]);
  e.nrm = sqrtf(clamp_min(ss, (float)1e-24));
  for (int i = 0; i < 4; ++i) e.qn[i] = e.q[i] / e.nrm;
  const float r = e.qn[0], x = e.qn[1], y = e.qn[2], z = e.qn[3];
  float* R = e.R;
  R[0] = 1.f - (y * y + z * z) * 2.f;
  R[1] = (x * y - r * z) * 2.f;
  R[2] = (x * z + r * y) * 2.f;
  R[3] = (x * y + r * z) * 2.f;
  R[4] = 1.f - (x * x + z * z) * 2.f;
  R[5] = (y * z - r * x) * 2.f;
  R[6] = (x * z - r * y) * 2.f;
  R[7] = (y * z + r * x) * 2.f;
  R[8] = 1.f - (x * x + y * y) * 2.f;
  for (int k = 0; k < 3; ++k) {
    e.s[k] = expf(ls[k]);
    e.var[k] = e.s[k] * e.s[k];
  }
  const float v0 = e.var[0], v1 = e.var[1], v2 = e.var[2];
  e.s00 = (R[0] * v0 * R[0] + R[1] * v1 * R[1]) + R[2] * v2 * R[2];
  e.s01 = (R[0] * v0 * R[3] + R[1] * v1 * R[4]) + R[2] * v2 * R[5];
  e.s02 = (R[0] * v0 * R[6] + R[1] * v1 * R[7]) + R[2] * v2 * R[8];
  e.s11 = (R[3] * v0 * R[3] + R[4] * v1 * R[4]) + R[5] * v2 * R[5];
  e.s12 = (R[3] * v0 * R[6] + R[4] * v1 * R[7]) + R[5] * v2 * R[8];
  e.s22 = (R[6] * v0 * R[6] + R[7] * v1 * R[7]) + R[8] * v2 * R[8];

  e.tz_nz = tz == 0.f ? (float)1e-7 : tz;
  e.xr = tx / e.tz_nz;
  e.yr = ty / e.tz_nz;
  e.txc = clamp(e.xr, -c.limx, c.limx) * tz;
  e.tyc = clamp(e.yr, -c.limy, c.limy) * tz;
  e.inv_z = (1.f / e.tz_nz) * 1.f;
  e.inv_z2 = e.inv_z * e.inv_z;
  e.j00 = e.inv_z * c.fx;
  e.j02 = (e.txc * c.neg_fx) * e.inv_z2;
  e.j11 = e.inv_z * c.fy;
  e.j12 = (e.tyc * c.neg_fy) * e.inv_z2;
  e.r0x = e.j00 * e.s00 + e.j02 * e.s02;
  e.r0z = e.j00 * e.s02 + e.j02 * e.s22;
  e.r1y = e.j11 * e.s11 + e.j12 * e.s12;
  e.r1z = e.j11 * e.s12 + e.j12 * e.s22;
  e.c00 = (e.r0x * e.j00 + e.r0z * e.j02) + (float)0.3;
  e.t01 = e.j00 * e.s01 + e.j02 * e.s12;
  e.c01 = e.t01 * e.j11 + e.r0z * e.j12;
  e.c11 = (e.r1y * e.j11 + e.r1z * e.j12) + (float)0.3;
  e.det = e.c00 * e.c11 - e.c01 * e.c01;
  e.det_safe = e.det != 0.f ? e.det : 1.f;
  e.cA = e.c11 / e.det_safe;
  e.cB = (-e.c01) / e.det_safe;
  e.cC = e.c00 / e.det_safe;
  const float mid = (e.c00 + e.c11) * 0.5f;
  const float disc = sqrtf(clamp_min(mid * mid - e.det, (float)0.1));
  const float lam1 = mid + disc;
  e.radius_f = ceilf(sqrtf(clamp_min(lam1, 0.f)) * 3.f);
}

// clamp(floor(x), 0, hi) as the float that the int64 cast takes
__device__ __forceinline__ float tile_edge(float x, int hi) {
  return clamp(floorf(x), 0.f, (float)hi);
}

// (x1 > x0) & (y1 > y0) of the rect (u -+ r, v -+ r) in tiles
__device__ __forceinline__ bool touches(float u, float v, float r,
                                        int tiles_x, int tiles_y) {
  const float inv = 1.f / 16.f;
  const float x0 = tile_edge((u - r) * inv, tiles_x);
  const float y0 = tile_edge((v - r) * inv, tiles_y);
  const float x1 = tile_edge((((u + r) + 16.f) - 1.f) * inv, tiles_x);
  const float y1 = tile_edge((((v + r) + 16.f) - 1.f) * inv, tiles_y);
  return x1 > x0 && y1 > y0;
}

__device__ __forceinline__ float sigmoid(float l) {
  return 1.f / (1.f + expf(-l));
}

// The block's table rows are staged in shared memory and written out as
// one contiguous stretch, neighbouring threads on neighbouring addresses
// (a row is 20-44 bytes, so a thread's own row stores would not be).
__global__ void __launch_bounds__(THREADS)
project_fwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ quats,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ logit_op,
                   const float* __restrict__ feats, int f_in,
                   const uint8_t* __restrict__ alive,
                   const float* __restrict__ offset, int N, int depth_col,
                   int mask_op, Cam c, float margin, int tiles_x,
                   int tiles_y, float* __restrict__ table,
                   int* __restrict__ radius, uint8_t* __restrict__ valid) {
  __shared__ float rows[THREADS * CMAX];
  const int i0 = blockIdx.x * THREADS;
  const int i = i0 + threadIdx.x;
  const int C = logit_op ? 6 + f_in + depth_col : 5;
  if (i < N) {
    Ewa e;
    ewa(means + (size_t)i * 3, quats + (size_t)i * 4,
        log_scales + (size_t)i * 3, c, e);
    float u = e.u, v = e.v;
    if (offset) {
      u = u + offset[(size_t)i * 2];
      v = v + offset[(size_t)i * 2 + 1];
    }
    const float tz = means[(size_t)i * 3 + 2];
    const float rd = e.radius_f;
    bool ok = alive[i] != 0 && tz > (float)0.2 && e.det != 0.f;
    ok = ok && touches(u, v, rd + margin, tiles_x, tiles_y) && rd > 0.f;
    radius[i] = ok ? (int)rd : 0;
    valid[i] = ok;
    float* row = rows + threadIdx.x * C;
    row[0] = u;
    row[1] = v;
    row[2] = e.cA;
    row[3] = e.cB;
    row[4] = e.cC;
    if (logit_op) {
      row[5] = mask_op && !ok ? 0.f : sigmoid(logit_op[i]);
      for (int j = 0; j < f_in; ++j)
        row[6 + j] = feats[(size_t)i * f_in + j];
      if (depth_col) row[6 + f_in] = tz;
    }
  }
  __syncthreads();
  const int n = min(THREADS, N - i0) * C;
  float* out = table + (size_t)i0 * C;
  for (int k = threadIdx.x; k < n; k += THREADS) out[k] = rows[k];
}

__global__ void __launch_bounds__(THREADS)
project_bwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ quats,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ logit_op,
                   const uint8_t* __restrict__ valid, int N, int f_in,
                   int depth_col, int mask_op, Cam c,
                   const float* __restrict__ dtable,
                   float* __restrict__ dmeans, float* __restrict__ dquats,
                   float* __restrict__ dlog_scales,
                   float* __restrict__ dlogit, float* __restrict__ dfeats,
                   float* __restrict__ doffset) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const float* m = means + (size_t)i * 3;
  Ewa e;
  ewa(m, quats + (size_t)i * 4, log_scales + (size_t)i * 3, c, e);
  const float tx = m[0], ty = m[1], tz = m[2];
  const int C = logit_op ? 6 + f_in + depth_col : 5;
  const float* g = dtable + (size_t)i * C;
  const float du = g[0], dv = g[1], dA = g[2], dB = g[3], dC = g[4];

  // the table's own columns
  if (dlogit) {
    const float op = sigmoid(logit_op[i]);
    const bool pass = !(mask_op && !valid[i]);
    dlogit[i] = pass ? g[5] * (1.f - op) * op : 0.f;
  }
  if (dfeats)
    for (int j = 0; j < f_in; ++j) dfeats[(size_t)i * f_in + j] = g[6 + j];
  if (doffset) {
    doffset[(size_t)i * 2] = du;
    doffset[(size_t)i * 2 + 1] = dv;
  }

  // conic = (c11, -c01, c00) / det_safe
  const float D = e.det_safe, D2 = D * D;
  float dc11 = dA / D, dc01 = -(dB / D), dc00 = dC / D;
  const float dD = ((-dA * e.c11) / D2 - (dB * -e.c01) / D2)
                   - (dC * e.c00) / D2;
  const float ddet = e.det != 0.f ? dD : 0.f;
  dc00 += ddet * e.c11;
  dc11 += ddet * e.c00;
  dc01 -= (ddet * e.c01) * 2.f;

  // the 2D covariance c = J S J^T + 0.3: through J S (r0x, r0z, t01, r1y,
  // r1z) to the Jacobian
  float dj00 = dc00 * e.r0x, dj02 = dc00 * e.r0z;
  const float dr0x = dc00 * e.j00;
  const float dr0z = dc00 * e.j02 + dc01 * e.j12;
  const float dt01 = dc01 * e.j11;
  float dj11 = dc01 * e.t01, dj12 = dc01 * e.r0z;
  dj00 += dt01 * e.s01;
  dj02 += dt01 * e.s12;
  const float dr1y = dc11 * e.j11, dr1z = dc11 * e.j12;
  dj11 += dc11 * e.r1y;
  dj12 += dc11 * e.r1z;
  dj00 = (dj00 + dr0x * e.s00) + dr0z * e.s02;
  dj02 = (dj02 + dr0x * e.s02) + dr0z * e.s22;
  dj11 = (dj11 + dr1y * e.s11) + dr1z * e.s12;
  dj12 = (dj12 + dr1y * e.s12) + dr1z * e.s22;

  // the Jacobian from the camera-frame mean
  float dinv_z = dj00 * c.fx + dj11 * c.fy;
  const float dinv_z2 = dj02 * (e.txc * c.neg_fx) + dj12 * (e.tyc * c.neg_fy);
  const float dtxc = (dj02 * e.inv_z2) * c.neg_fx;
  const float dtyc = (dj12 * e.inv_z2) * c.neg_fy;
  dinv_z += (dinv_z2 * e.inv_z) * 2.f;
  float dtz_nz = -dinv_z * e.inv_z2;
  float dtx = 0.f, dty = 0.f, dtz = 0.f;
  const float xc = clamp(e.xr, -c.limx, c.limx);
  const float yc = clamp(e.yr, -c.limy, c.limy);
  dtz += dtxc * xc + dtyc * yc;
  const float dxr = (e.xr >= -c.limx && e.xr <= c.limx) ? dtxc * tz : 0.f;
  const float dyr = (e.yr >= -c.limy && e.yr <= c.limy) ? dtyc * tz : 0.f;
  const float nz2 = e.tz_nz * e.tz_nz;
  dtx += dxr / e.tz_nz;
  dty += dyr / e.tz_nz;
  dtz_nz -= (dxr * tx) / nz2 + (dyr * ty) / nz2;
  if (tz != 0.f) dtz += dtz_nz;

  // the pixel centre
  const float ts2 = e.tz_safe * e.tz_safe;
  dtx += (du / e.tz_safe) * c.fx;
  dty += (dv / e.tz_safe) * c.fy;
  dtz -= (du * (tx * c.fx)) / ts2 + (dv * (ty * c.fy)) / ts2;
  if (depth_col) dtz += g[6 + f_in];
  dmeans[(size_t)i * 3] = dtx;
  dmeans[(size_t)i * 3 + 1] = dty;
  dmeans[(size_t)i * 3 + 2] = dtz;

  // the 3D covariance S = R diag(var) R^T, through M = J R: d S = J^T dc J
  // (dc symmetric, dc01 / 2 off the diagonal), so d var_k = m_k^T dc m_k
  // and d R = 2 J^T dc M diag(var). Formed from M's columns m_k, these sums
  // do not cancel as the six entries of d S do where a footprint is thin.
  const float* R = e.R;
  const float h = 0.5f * dc01;
  float dR[9];
  for (int k = 0; k < 3; ++k) {
    const float m0 = e.j00 * R[k] + e.j02 * R[6 + k];
    const float m1 = e.j11 * R[3 + k] + e.j12 * R[6 + k];
    const float p0 = dc00 * m0 + h * m1;
    const float p1 = h * m0 + dc11 * m1;
    const float w = 2.f * e.var[k];
    dR[k] = w * (e.j00 * p0);
    dR[3 + k] = w * (e.j11 * p1);
    dR[6 + k] = w * (e.j02 * p0 + e.j12 * p1);
    dlog_scales[(size_t)i * 3 + k] = (m0 * p0 + m1 * p1) * 2.f * e.s[k]
                                     * e.s[k];
  }

  // the rotation from the normalised quaternion
  const float r = e.qn[0], x = e.qn[1], y = e.qn[2], z = e.qn[3];
  float dqn[4];
  dqn[0] = 2.f * ((-z * dR[1] + y * dR[2]) + (z * dR[3] - x * dR[5])
                  + (-y * dR[6] + x * dR[7]));
  dqn[1] = 2.f * ((y * dR[1] + z * dR[2]) + (y * dR[3] - 2.f * x * dR[4])
                  + (-r * dR[5] + z * dR[6]) + (r * dR[7] - 2.f * x * dR[8]));
  dqn[2] = 2.f * ((-2.f * y * dR[0] + x * dR[1]) + (r * dR[2] + x * dR[3])
                  + (z * dR[5] - r * dR[6]) + (z * dR[7] - 2.f * y * dR[8]));
  dqn[3] = 2.f * ((-2.f * z * dR[0] - r * dR[1]) + (x * dR[2] + r * dR[3])
                  + (-2.f * z * dR[4] + y * dR[5]) + (x * dR[6] + y * dR[7]));

  // qn = q / sqrt(clamp(|q|^2, 1e-24))
  float dot = 0.f;
  for (int k = 0; k < 4; ++k) dot += dqn[k] * e.qn[k];
  const float dnrm = -dot / e.nrm;
  const float ss = (e.q[0] * e.q[0] + e.q[2] * e.q[2])
                   + (e.q[1] * e.q[1] + e.q[3] * e.q[3]);
  const float dss = ss >= (float)1e-24 ? dnrm / (2.f * e.nrm) : 0.f;
  for (int k = 0; k < 4; ++k)
    dquats[(size_t)i * 4 + k] = dqn[k] / e.nrm + dss * 2.f * e.q[k];
}

Cam make_cam(float fx, float fy, float cx, float cy, float limx,
             float limy) {
  Cam c;
  c.fx = fx;
  c.fy = fy;
  c.cx = cx;
  c.cy = cy;
  c.neg_fx = -fx;
  c.neg_fy = -fy;
  c.limx = limx;
  c.limy = limy;
  return c;
}

}  // namespace

// C interface (loaded with ctypes): each returns cudaGetLastError() of its
// launch, or cudaErrorInvalidValue for a table wider than CMAX. Pointers
// that may be null: logit_op (the table is then the five columns u, v, A,
// B, C, with f_in = 0 and no depth column: the binning's projection),
// feats (f_in = 0), offset; in the backward dlogit, dfeats and doffset
// (that gradient is not written).
extern "C" int project_fwd(const float* means, const float* quats,
                           const float* log_scales, const float* logit_op,
                           const float* feats, int f_in, const void* alive,
                           const float* offset, int N, int depth_col,
                           int mask_op, float fx, float fy, float cx,
                           float cy, float limx, float limy, float margin,
                           int tiles_x, int tiles_y, float* table,
                           int* radius, void* valid, void* stream) {
  if (f_in < 0 || 6 + f_in + depth_col > CMAX)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (N + THREADS - 1) / THREADS;
  project_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      means, quats, log_scales, logit_op, feats, f_in,
      (const uint8_t*)alive, offset, N, depth_col, mask_op,
      make_cam(fx, fy, cx, cy, limx, limy), margin, tiles_x, tiles_y, table,
      radius, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

extern "C" int project_bwd(const float* means, const float* quats,
                           const float* log_scales, const float* logit_op,
                           const void* valid, int N, int f_in, int depth_col,
                           int mask_op, float fx, float fy, float limx,
                           float limy, const float* dtable, float* dmeans,
                           float* dquats, float* dlog_scales, float* dlogit,
                           float* dfeats, float* doffset, void* stream) {
  if (N == 0) return 0;
  const int blocks = (N + THREADS - 1) / THREADS;
  project_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      means, quats, log_scales, logit_op, (const uint8_t*)valid, N, f_in,
      depth_col, mask_op, make_cam(fx, fy, 0.f, 0.f, limx, limy), dtable,
      dmeans, dquats, dlog_scales, dlogit, dfeats, doffset);
  return (int)cudaGetLastError();
}
