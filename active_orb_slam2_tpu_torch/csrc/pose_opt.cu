// Fused motion-only bundle adjustment (Optimizer::PoseOptimization).
//
// Replaces the Pallas kernel of active_orb_slam2_tpu/ops/pose_opt_kernel.py
// (_build_kernel, launched by _pose_opt_call): 4 rounds x 10 damped
// Gauss-Newton iterations over E projection edges, Huber-weighted in rounds
// 0-1, with chi2-carried accept/reject, a final acceptance of the last step
// and chi2 reclassification between rounds.  One launch runs the whole
// optimization.
//
// What bounds it on Hopper: latency per pass.  The optimization is a chain
// of dependent passes over the edges; each linearizes <= 2048 edges at the
// current pose (~280 FLOP an edge), sums 28 terms over the block and solves
// a 6x6 system whose result the next pass needs.  The work of a pass is a
// few hundred cycles of one SM; what a pass costs is the length of its
// dependent chain: loads, the block reduction, barriers, and the serial
// solve and retract.  So the chain stays in one block, and the design
// shortens each link:
//
//   - each thread loads its edges once, at kernel start, into registers
//     (the kernel is templated on edges per thread so the loop unrolls);
//     the inlier flags live in registers and the mask is written once;
//   - a pass has one barrier: each warp reduces its 28 sums with a
//     transpose butterfly (31 shuffles, lane i ends with sum i), lanes
//     0-27 write them to a double-buffered shared array, and after the
//     barrier every warp adds the per-warp partials in the same fixed
//     order (lane i sum i, read back by all lanes from the warp's own
//     shared slot) and runs the damping, the solve and the retract, so
//     every warp holds the same pose, lambda, best pose and best chi2
//     and no thread waits for a broadcast (no atomics: a rerun gives
//     identical bits);
//   - the solve multiplies by the reciprocal pivots of the factorization,
//     and the retract takes one sincosf(t/2) and the double-angle
//     identities in place of four transcendentals;
//   - the reclassification after a round needs no pass of its own: it is
//     per edge, so the next round's first linearization, at the same
//     pose, does it; after the last round the acceptance pass also
//     reclassifies at both candidate poses (the chi2 of each edge at the
//     round's best pose is kept in registers) and sums the inlier chi2
//     and count of each, so the 4 x 10 schedule takes 44 passes.
//
// Inputs as the tracking step holds them: pose0 [7] (q, t), pw [E, 3],
// obs [E, 3] (u, v, uR), level int32 [E], stereo and valid bool [E], and
// the per-level information table (inv_sigma2 of levels 0..n_table-1, so
// w_info has the plain version's bits).  Outputs: out [8] (pose, inlier
// chi2), n_inliers int32, mask bool [E].
//
// A launch solves P independent problems of E edges each (the
// relocalizer's candidates): every array above gains a leading axis of P,
// and block b of a grid of P blocks runs the code of a single problem on
// problem b's slices.  Nothing is shared between blocks, so a problem's
// result in a batch has the bits of its own launch.

#include <cuda_runtime.h>

namespace {

constexpr int kSums = 28;   // 21 H terms, 6 b terms, chi2
// One block of 256 threads: 128 and 512 read slower on an H100 (PERF.md).
constexpr int kThreads = 256;
constexpr int kMaxEdgesPerThread = 8;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Args {
  const float* pose0;
  const float* pw;
  const float* obs;
  const int* level;
  const unsigned char* stereo;
  const unsigned char* valid;
  const float* w_table;
  int n_table;
  int E;
  Cam cam;
  int rounds, iters;
  float* out;
  int* n_inliers;
  unsigned char* mask;
};

__device__ __forceinline__ void quat_rotate(const float* q, float vx, float vy,
                                            float vz, float* o) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float uvx = qy * vz - qz * vy + qw * vx;
  const float uvy = qz * vx - qx * vz + qw * vy;
  const float uvz = qx * vy - qy * vx + qw * vz;
  o[0] = vx + 2.0f * (qy * uvz - qz * uvy);
  o[1] = vy + 2.0f * (qz * uvx - qx * uvz);
  o[2] = vz + 2.0f * (qx * uvy - qy * uvx);
}

// One edge at pose p: the camera-frame point pc and the residual r, as
// models/optimizer.py::edge_terms.
struct Proj {
  float x, y, z, iz, iz2;
  float r[3];
};

__device__ __forceinline__ Proj project(const float* p, float X, float Y,
                                        float Z, float ou, float ov,
                                        float our, float stf, const Cam& c) {
  float pc[3];
  quat_rotate(p, X, Y, Z, pc);
  Proj o;
  o.x = pc[0] + p[4];
  o.y = pc[1] + p[5];
  o.z = pc[2] + p[6];
  const float zs = fabsf(o.z) < 1e-9f ? 1e-9f : o.z;
  o.iz = __frcp_rn(zs);
  o.iz2 = o.iz * o.iz;
  const float u = c.fx * o.x * o.iz + c.cx;
  const float v = c.fy * o.y * o.iz + c.cy;
  const float ur = u - c.bf * o.iz;
  o.r[0] = u - ou;
  o.r[1] = v - ov;
  o.r[2] = stf * (ur - our);
  return o;
}

// Adds edge e's weighted terms to the 21 H + 6 b sums.  With the
// left-perturbation Jacobian J = [-D P | D], D = d r / d pc (3x3, zeros
// at (0,1), (1,0), (2,1)) and P = [pc]x, the terms are, with M = w D^T D:
// H_tt = M, H_rt = P M, H_rr = -P M P, b_t = w D^T r, b_r = P b_t
// (P^T = -P).  Summing them in this form skips J and D's zeros.
__device__ __forceinline__ void add_normal_terms(const Proj& e, float stf,
                                                 float w, const Cam& c,
                                                 float (&acc)[28]) {
  const float x = e.x, y = e.y, z = e.z;
  const float da = c.fx * e.iz, db = -c.fx * x * e.iz2;   // D row 0: a 0 b
  const float dc = c.fy * e.iz, dd = -c.fy * y * e.iz2;   // D row 1: 0 c d
  const float de = stf * da, df = stf * (db + c.bf * e.iz2);  // row 2: e 0 f
  const float m00 = w * (da * da + de * de), m02 = w * (da * db + de * df);
  const float m11 = w * (dc * dc), m12 = w * (dc * dd);
  const float m22 = w * (db * db + dd * dd + df * df);
  const float M[3][3] = {{m00, 0.f, m02}, {0.f, m11, m12}, {m02, m12, m22}};
  float PM[3][3];                                          // P M
  PM[0][0] = y * m02;
  PM[1][0] = z * m00 - x * m02;
  PM[2][0] = -y * m00;
#pragma unroll
  for (int j = 1; j < 3; ++j) {
    PM[0][j] = y * M[2][j] - z * M[1][j];
    PM[1][j] = z * M[0][j] - x * M[2][j];
    PM[2][j] = x * M[1][j] - y * M[0][j];
  }
  // H_rr[i][j] = -(P M P)[i][j] for j <= i
  acc[0] += PM[0][2] * y - PM[0][1] * z;
  acc[1] += PM[1][2] * y - PM[1][1] * z;
  acc[2] += PM[1][0] * z - PM[1][2] * x;
  acc[3] += PM[2][2] * y - PM[2][1] * z;
  acc[4] += PM[2][0] * z - PM[2][2] * x;
  acc[5] += PM[2][1] * x - PM[2][0] * y;
  // rows 3-5: H[3 + p][q] = (P M)[q][p] for q < 3, then M (H[4][3] = 0)
  acc[6] += PM[0][0];
  acc[7] += PM[1][0];
  acc[8] += PM[2][0];
  acc[9] += m00;
  acc[10] += PM[0][1];
  acc[11] += PM[1][1];
  acc[12] += PM[2][1];
  acc[14] += m11;
  acc[15] += PM[0][2];
  acc[16] += PM[1][2];
  acc[17] += PM[2][2];
  acc[18] += m02;
  acc[19] += m12;
  acc[20] += m22;
  const float* r = e.r;
  const float g0 = w * (da * r[0] + de * r[2]), g1 = w * (dc * r[1]);
  const float g2 = w * (db * r[0] + dd * r[1] + df * r[2]);
  acc[21] += y * g2 - z * g1;
  acc[22] += z * g0 - x * g2;
  acc[23] += x * g1 - y * g0;
  acc[24] += g0;
  acc[25] += g1;
  acc[26] += g2;
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// One butterfly step over the first n values: the lanes of each pair at
// offset o keep opposite halves and add the partner's copy of theirs.
template <int M, int n, int o>
__device__ __forceinline__ void halve(float (&x)[M], unsigned lane) {
  if constexpr (n > 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? x[i] : x[i + n / 2];
      const float keep = upper ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
    halve<M, n / 2, o / 2>(x, lane);
  }
}

// Warp reduce-scatter of N values per lane: a transpose butterfly halves
// the values at each of the offsets 16, 8, ... (M - 1 shuffles for M, the
// power of two >= N), then plain xor steps sum the rest.  Afterwards lane
// l holds the warp's sum of value l / (32 / M).  The order of the sums is
// fixed, and a + b == b + a, so both lanes of a pair keep equal bits.
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(const float (&v)[N]) {
  constexpr int M = pow2_at_least(N);
  static_assert(M <= 32, "at most 32 sums");
  const unsigned lane = threadIdx.x & 31u;
  float x[M];
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = i < N ? v[i] : 0.f;
  halve<M, M, 16>(x, lane);
  float s = x[0];
#pragma unroll
  for (int o = 16 / M; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// Block-wide sums of N per-thread values, in a fixed order, with one
// barrier; every thread gets all N totals.  part is this pass's half of
// the double buffer: a warp writes the other half in the next pass only
// after every warp has passed this barrier, so no second barrier.  Lane
// i < N of each warp adds the warp partials of sum i and puts it in the
// warp's own slot, from which every lane reads all N (broadcast loads in
// place of N shuffles); the slot is written again only after the next
// pass's barrier.
template <int W, int N>
__device__ __forceinline__ void block_sum(const float (&v)[N],
                                          float (*part)[32], float* slot,
                                          float (&tot)[N]) {
  constexpr int S = 32 / pow2_at_least(N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float s = warp_reduce_scatter<N>(v);
  if (lane % S == 0 && lane / S < N) part[warp][lane / S] = s;
  __syncthreads();
  if (lane < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) t += part[w][lane];
    slot[lane] = t;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N; ++i) tot[i] = slot[i];
}

// Cholesky solve of the damped 6x6 system (optimizer.solve_spd): the
// factorization keeps only the reciprocal pivots (one rsqrt each), and
// the triangular solves multiply by them.
__device__ __forceinline__ void solve_spd6(const float (&h)[6][6],
                                           const float (&b)[6],
                                           float (&x)[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = h[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    inv[j] = rsqrtf(fmaxf(s, 1e-20f));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = h[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// exp(step) * pose, as geometry/se3.py::se3_retract: sin t and 1 - cos t
// from sincos(t / 2) by the double-angle identities, 1 / t and the
// quaternion's norm by rsqrt.
__device__ __forceinline__ void retract(const float (&pose)[7],
                                        const float (&d)[6], float (&out)[7]) {
  const float wx = d[0], wy = d[1], wz = d[2];
  const float vx = d[3], vy = d[4], vz = d[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float rt = rsqrtf(fmaxf(t2, 1e-30f));      // 1 / t
  const float t = t2 * rt;
  const bool small = t < 1e-6f;
  float sh, ch;
  sincosf(0.5f * t, &sh, &ch);
  const float sin_t = 2.0f * sh * ch;
  const float k = small ? 0.5f - t2 * (1.0f / 48.0f) : sh * rt;
  const float eq[4] = {small ? 1.0f - t2 * 0.125f : ch, k * wx, k * wy,
                       k * wz};
  const float a = small ? 0.5f - t2 * (1.0f / 24.0f) : 2.0f * sh * sh * rt * rt;
  const float bb = small ? 1.0f / 6.0f - t2 * (1.0f / 120.0f)
                         : (t - sin_t) * rt * rt * rt;
  const float w1x = wy * vz - wz * vy, w1y = wz * vx - wx * vz,
              w1z = wx * vy - wy * vx;
  const float w2x = wy * w1z - wz * w1y, w2y = wz * w1x - wx * w1z,
              w2z = wx * w1y - wy * w1x;
  const float* q = pose;
  const float nq[4] = {
      eq[0] * q[0] - eq[1] * q[1] - eq[2] * q[2] - eq[3] * q[3],
      eq[0] * q[1] + eq[1] * q[0] + eq[2] * q[3] - eq[3] * q[2],
      eq[0] * q[2] - eq[1] * q[3] + eq[2] * q[0] + eq[3] * q[1],
      eq[0] * q[3] + eq[1] * q[2] - eq[2] * q[1] + eq[3] * q[0]};
  const float inv = rsqrtf(fmaxf(
      nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] + nq[3] * nq[3], 1e-24f));
  float rt3[3];
  quat_rotate(eq, pose[4], pose[5], pose[6], rt3);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = nq[i] * inv;
  out[4] = rt3[0] + (vx + a * w1x + bb * w2x);
  out[5] = rt3[1] + (vy + a * w1y + bb * w2y);
  out[6] = rt3[2] + (vz + a * w1z + bb * w2z);
}

__device__ __forceinline__ bool bit(unsigned m, int k) { return (m >> k) & 1u; }

// One block of T threads per problem, each thread holding EPT edges: edge
// k of thread i is edge k * T + i.  A block is alone on its SM (P <= 132
// blocks in the relocalizer's use, one in tracking), so the bounds tell
// the compiler it may spend registers on one block per SM (at 256
// threads and 4 edges it otherwise stops at 128 and spills).
template <int T, int EPT>
__global__ void __launch_bounds__(T, 1) pose_opt_kernel(Args a) {
  constexpr int W = T / 32;
  __shared__ float part[2][W][32];
  __shared__ __align__(16) float slots[W][32];
  const int tid = threadIdx.x;
  float* slot = slots[tid >> 5];
  const Cam& cam = a.cam;
  // problem blockIdx.x's slices
  const size_t pb = blockIdx.x, eb = pb * (size_t)a.E;
  a.pose0 += 7 * pb;
  a.pw += 3 * eb;
  a.obs += 3 * eb;
  a.level += eb;
  a.stereo += eb;
  a.valid += eb;
  a.out += 8 * pb;
  a.n_inliers += pb;
  a.mask += eb;
  const float delta_mono = __fsqrt_rn(kChi2Mono);      // Huber deltas
  const float delta_stereo = __fsqrt_rn(kChi2Stereo);

  // The edges, in registers for the whole optimization.  A slot past
  // the last edge holds a copy of it with weight 0 and no valid flag, so
  // its terms are exact zeros and the edge loops need no branch, which
  // lets the compiler interleave a thread's edges.
  float X[EPT], Y[EPT], Z[EPT], ou[EPT], ov[EPT], our[EPT], w_info[EPT];
  float c2_now[EPT], c2_best[EPT];  // chi2 at this pass's / the best pose
  unsigned live = 0, stereo = 0, valid = 0, inl = 0, zpos_now = 0,
           zpos_best = 0;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const bool on = k * T + tid < a.E;
    const int e = on ? k * T + tid : a.E - 1;
    X[k] = a.pw[3 * e];
    Y[k] = a.pw[3 * e + 1];
    Z[k] = a.pw[3 * e + 2];
    ou[k] = a.obs[3 * e];
    ov[k] = a.obs[3 * e + 1];
    our[k] = a.obs[3 * e + 2];
    const int lv = min(max(a.level[e], 0), a.n_table - 1);
    w_info[k] = on ? a.w_table[lv] : 0.f;
    c2_now[k] = c2_best[k] = 0.f;
    live |= (unsigned)on << k;
    stereo |= (unsigned)(a.stereo[e] != 0) << k;
    valid |= (unsigned)(on && a.valid[e]) << k;
  }
  inl = valid;
  float pose[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) pose[i] = a.pose0[i];

  int buf = 0;
  float chi2_out = 0.f, n_out = 0.f;
  for (int rnd = 0; rnd < a.rounds; ++rnd) {
    const bool huber = rnd < 2;
    const bool last = rnd == a.rounds - 1;
    float best[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) best[i] = pose[i];
    float best_chi2 = __int_as_float(0x7f800000);   // +inf
    float lam = 1e-4f;

    for (int it = 0; it < a.iters; ++it) {
      // the previous round's reclassification, at this same pose
      const bool reclassify = it == 0 && rnd > 0;
      float acc[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
      zpos_now = 0;
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const float stf = bit(stereo, k) ? 1.f : 0.f;
        const Proj e = project(pose, X[k], Y[k], Z[k], ou[k], ov[k], our[k],
                               stf, cam);
        const float c2 = w_info[k] * (e.r[0] * e.r[0] + e.r[1] * e.r[1] +
                                      e.r[2] * e.r[2]);
        const bool zp = e.z > 0.f;
        const float th = bit(stereo, k) ? kChi2Stereo : kChi2Mono;
        if (reclassify) {
          const bool keep = bit(valid, k) && zp && c2 <= th;
          inl = (inl & ~(1u << k)) | ((unsigned)keep << k);
        }
        c2_now[k] = c2;
        zpos_now |= (unsigned)zp << k;
        const float gate = (bit(inl, k) ? 1.f : 0.f) * (zp ? 1.f : 0.f);
        acc[27] += c2 * gate;
        const float delta = bit(stereo, k) ? delta_stereo : delta_mono;
        const float hub =
            huber ? fminf(1.f, delta * rsqrtf(fmaxf(c2, 1e-12f))) : 1.f;
        add_normal_terms(e, stf, w_info[k] * hub * gate, cam, acc);
      }
      float tot[kSums];
      block_sum<W, kSums>(acc, part[buf], slot, tot);
      buf ^= 1;

      const float chi2 = tot[27];
      const bool worse = chi2 > best_chi2;
      lam = fminf(fmaxf(worse ? lam * 4.0f : lam * 0.5f, 1e-8f), 1e2f);
      if (!worse) {
#pragma unroll
        for (int i = 0; i < 7; ++i) best[i] = pose[i];
#pragma unroll
        for (int k = 0; k < EPT; ++k) c2_best[k] = c2_now[k];
        zpos_best = zpos_now;
      }
      best_chi2 = fminf(chi2, best_chi2);
      float H[6][6], b[6], step[6];
      int n = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          H[i][j] = tot[n];
          H[j][i] = tot[n];
          ++n;
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        b[i] = -tot[21 + i];
        H[i][i] = (H[i][i] + lam * H[i][i]) + 1e-9f;
      }
      solve_spd6(H, b, step);
      if (worse) {
#pragma unroll
        for (int i = 0; i < 7; ++i) pose[i] = best[i];
      } else {
        float np[7];
        retract(pose, step, np);
#pragma unroll
        for (int i = 0; i < 7; ++i) pose[i] = np[i];
      }
    }

    // Final acceptance of the last proposed step.  After the last round
    // the same pass reclassifies at both candidate poses: sums 1-2 are
    // the inlier chi2 and count at this pose, 3-4 at the best pose.
    float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    unsigned inl_now = 0, inl_best = 0;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const float stf = bit(stereo, k) ? 1.f : 0.f;
      const Proj e = project(pose, X[k], Y[k], Z[k], ou[k], ov[k], our[k],
                             stf, cam);
      const float c2 = w_info[k] * (e.r[0] * e.r[0] + e.r[1] * e.r[1] +
                                    e.r[2] * e.r[2]);
      const bool zp = e.z > 0.f;
      acc[0] += c2 * (bit(inl, k) ? 1.f : 0.f) * (zp ? 1.f : 0.f);
      if (last) {
        const float th = bit(stereo, k) ? kChi2Stereo : kChi2Mono;
        const bool in_now = bit(valid, k) && zp && c2 <= th;
        const bool in_best =
            bit(valid, k) && bit(zpos_best, k) && c2_best[k] <= th;
        acc[1] += c2 * (in_now ? 1.f : 0.f);
        acc[2] += in_now ? 1.f : 0.f;
        acc[3] += c2_best[k] * (in_best ? 1.f : 0.f);
        acc[4] += in_best ? 1.f : 0.f;
        inl_now |= (unsigned)in_now << k;
        inl_best |= (unsigned)in_best << k;
      }
    }
    float tot[5];
    block_sum<W, 5>(acc, part[buf], slot, tot);
    buf ^= 1;
    const bool better = tot[0] <= best_chi2;
    if (!better) {
#pragma unroll
      for (int i = 0; i < 7; ++i) pose[i] = best[i];
    }
    if (last) {
      inl = better ? inl_now : inl_best;
      chi2_out = better ? tot[1] : tot[3];
      n_out = better ? tot[2] : tot[4];
    }
  }

#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = k * T + tid;
    if (bit(live, k)) a.mask[e] = bit(inl, k);
  }
  if (tid < 7) a.out[tid] = pose[tid];
  if (tid == 0) {
    a.out[7] = chi2_out;
    *a.n_inliers = (int)n_out;
  }
}

template <int EPT>
int launch(const Args& a, int P, cudaStream_t stream) {
  pose_opt_kernel<kThreads, EPT><<<P, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// P problems of E edges each, arrays [P, ...] contiguous; P >= 1,
// 1 <= E <= kThreads * kMaxEdgesPerThread (2048); rounds, iters >= 1.
extern "C" int aos2_pose_opt(const float* pose0, const float* pw,
                             const float* obs, const int* level,
                             const unsigned char* stereo,
                             const unsigned char* valid, const float* w_table,
                             int n_table, int P, int E, float fx, float fy,
                             float cx, float cy, float bf, int rounds,
                             int iters, float* out, int* n_inliers,
                             unsigned char* mask, cudaStream_t stream) {
  if (P < 1 || E < 1 || n_table < 1 || rounds < 1 || iters < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{pose0,  pw,    obs,    level, stereo,    valid,
               w_table, n_table, E,   Cam{fx, fy, cx, cy, bf},
               rounds, iters, out,    n_inliers, mask};
  const int ept = (E + kThreads - 1) / kThreads;
  if (ept <= 1) return launch<1>(a, P, stream);
  if (ept <= 2) return launch<2>(a, P, stream);
  if (ept <= 4) return launch<4>(a, P, stream);
  if (ept <= kMaxEdgesPerThread) return launch<8>(a, P, stream);
  return (int)cudaErrorInvalidValue;
}
