// Fused motion-only bundle adjustment (Optimizer::PoseOptimization).
//
// Replaces the Pallas kernel of active_orb_slam2_tpu/ops/pose_opt_kernel.py
// (_build_kernel, launched by _pose_opt_call): 4 rounds x 10 damped
// Gauss-Newton iterations over E projection edges, Huber-weighted in rounds
// 0-1, with chi2-carried accept/reject, a final acceptance of the last step
// and chi2 reclassification between rounds.  One launch runs the whole
// optimization.
//
// What bounds it on Hopper: latency.  The optimization is a chain of 49
// linearizations over <= 1024 edges; each needs ~150 FLOP per edge and a
// 6x6 solve that depends on the previous one, so there is nothing to
// spread over more than one SM and no bandwidth to speak of (the edge data
// is 40 KB and stays in L1).  The design keeps the whole chain in one
// block: 256 threads stride over the edges and keep nothing per edge but
// registers; the 21 H + 6 b + chi2 partial sums are reduced with warp
// shuffles and then across warps through shared memory in a fixed order,
// with no atomics, so a rerun is bit-identical; one thread then runs the
// damping, the unrolled Cholesky and the SE3 retract and broadcasts the
// pose through shared memory.  The per-edge inlier flags live in the mask
// output, which each thread only touches at its own edges.
//
// Layout (as the Pallas kernel's): pose_in [8] (q, t, unused), pw [3, E],
// obs [3, E] (u, v, uR), aux [4, E] (w_info, stereo flag, valid, chi2
// threshold); out [8] (pose, inlier chi2), mask [E] (inlier 0/1).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;   // 21 H terms, 6 b terms, chi2
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Edge {
  float r[3];
  float J[3][6];
  float pcz;
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

// Residual and pose Jacobian of edge e at pose p (left perturbation).
__device__ __forceinline__ void linearize(const float* p, const float* pw,
                                          const float* obs, float stf, int e,
                                          int E, const Cam& c, Edge& out) {
  float pc[3];
  quat_rotate(p, pw[e], pw[E + e], pw[2 * E + e], pc);
  const float x = pc[0] + p[4], y = pc[1] + p[5], z = pc[2] + p[6];
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float iz = 1.0f / zs;
  const float iz2 = iz * iz;
  const float u = c.fx * x * iz + c.cx;
  const float v = c.fy * y * iz + c.cy;
  const float ur = u - c.bf * iz;
  out.r[0] = u - obs[e];
  out.r[1] = v - obs[E + e];
  out.r[2] = stf * (ur - obs[2 * E + e]);
  const float jpc[3][3] = {
      {c.fx * iz, 0.f, -c.fx * x * iz2},
      {0.f, c.fy * iz, -c.fy * y * iz2},
      {stf * c.fx * iz, 0.f, stf * (-c.fx * x * iz2 + c.bf * iz2)}};
  const float px[3][3] = {{0.f, -z, y}, {z, 0.f, -x}, {-y, x, 0.f}};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out.J[a][i] = -(jpc[a][0] * px[0][i] + jpc[a][1] * px[1][i] +
                      jpc[a][2] * px[2][i]);
      out.J[a][3 + i] = jpc[a][i];
    }
  }
  out.pcz = z;
}

__device__ __forceinline__ float chi2_of(const Edge& ed, float w_info) {
  return w_info * (ed.r[0] * ed.r[0] + ed.r[1] * ed.r[1] + ed.r[2] * ed.r[2]);
}

// Block-wide sum of n per-thread values in a fixed order; the result is
// in tot[0..n) after the call (all threads).
template <int N>
__device__ void block_sum(float (&v)[N], float (*part)[kSums], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = v[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) part[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Unrolled Cholesky solve of the damped 6x6 system (optimizer.solve_spd).
__device__ void solve_spd6(const float (&h)[6][6], const float (&b)[6],
                           float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = h[j][j];
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(s, 1e-20f));
    const float inv_d = 1.0f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float t = h[i][j];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv_d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// exp(step) * pose, matching geometry/se3.py::se3_retract.
__device__ void retract(const float* pose, const float (&d)[6], float* out) {
  const float wx = d[0], wy = d[1], wz = d[2];
  const float vx = d[3], vy = d[4], vz = d[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float t = sqrtf(t2);
  const bool small = t < 1e-6f;
  const float k = small ? 0.5f - t2 / 48.0f : sinf(0.5f * t) / fmaxf(t, 1e-20f);
  const float eq[4] = {small ? 1.0f - t2 / 8.0f : cosf(0.5f * t), k * wx,
                       k * wy, k * wz};
  const float a = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(t)) / fmaxf(t2, 1e-20f);
  const float bb = small ? 1.0f / 6.0f - t2 / 120.0f
                         : (t - sinf(t)) / fmaxf(t2 * t, 1e-20f);
  const float w1x = wy * vz - wz * vy, w1y = wz * vx - wx * vz,
              w1z = wx * vy - wy * vx;
  const float w2x = wy * w1z - wz * w1y, w2y = wz * w1x - wx * w1z,
              w2z = wx * w1y - wy * w1x;
  const float etx = vx + a * w1x + bb * w2x;
  const float ety = vy + a * w1y + bb * w2y;
  const float etz = vz + a * w1z + bb * w2z;
  const float* q = pose;
  const float nq[4] = {
      eq[0] * q[0] - eq[1] * q[1] - eq[2] * q[2] - eq[3] * q[3],
      eq[0] * q[1] + eq[1] * q[0] + eq[2] * q[3] - eq[3] * q[2],
      eq[0] * q[2] - eq[1] * q[3] + eq[2] * q[0] + eq[3] * q[1],
      eq[0] * q[3] + eq[1] * q[2] - eq[2] * q[1] + eq[3] * q[0]};
  const float norm =
      sqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] + nq[3] * nq[3]);
  const float inv = 1.0f / fmaxf(norm, 1e-12f);
  float rt[3];
  quat_rotate(eq, pose[4], pose[5], pose[6], rt);
  for (int i = 0; i < 4; ++i) out[i] = nq[i] * inv;
  out[4] = rt[0] + etx;
  out[5] = rt[1] + ety;
  out[6] = rt[2] + etz;
}

__global__ void __launch_bounds__(kThreads)
pose_opt_kernel(const float* __restrict__ pose_in, const float* __restrict__ pw,
                const float* __restrict__ obs, const float* __restrict__ aux,
                int E, Cam cam, int rounds, int iters, float* __restrict__ out,
                float* __restrict__ inl) {
  __shared__ float part[kWarps][kSums];
  __shared__ float tot[kSums];
  __shared__ float s_pose[7], s_best[7];
  __shared__ float s_best_chi2, s_lam;

  const float* w_info = aux;
  const float* stf = aux + E;
  const float* valid = aux + 2 * E;
  const float* chi2_th = aux + 3 * E;
  const int tid = threadIdx.x;

  for (int e = tid; e < E; e += kThreads) inl[e] = valid[e];
  if (tid < 7) s_pose[tid] = pose_in[tid];
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    if (tid < 7) s_best[tid] = s_pose[tid];
    if (tid == 0) {
      s_best_chi2 = __int_as_float(0x7f800000);   // +inf
      s_lam = 1e-4f;
    }
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      float acc[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
      for (int e = tid; e < E; e += kThreads) {
        Edge ed;
        linearize(s_pose, pw, obs, stf[e], e, E, cam, ed);
        const float c2 = chi2_of(ed, w_info[e]);
        const float gate = inl[e] * (ed.pcz > 0.f ? 1.f : 0.f);
        acc[27] += c2 * gate;
        float hub = 1.f;
        if (huber) {
          const float delta = sqrtf(stf[e] > 0.f ? kChi2Stereo : kChi2Mono);
          hub = fminf(1.f, delta / sqrtf(fmaxf(c2, 1e-12f)));
        }
        const float w = w_info[e] * hub * gate;
        int n = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            acc[n++] += w * (ed.J[0][i] * ed.J[0][j] + ed.J[1][i] * ed.J[1][j] +
                             ed.J[2][i] * ed.J[2][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          acc[21 + i] += w * (ed.J[0][i] * ed.r[0] + ed.J[1][i] * ed.r[1] +
                              ed.J[2][i] * ed.r[2]);
        }
      }
      block_sum<kSums>(acc, part, tot);
      if (tid == 0) {
        const float chi2 = tot[27];
        const bool worse = chi2 > s_best_chi2;
        s_lam = fminf(fmaxf(worse ? s_lam * 4.0f : s_lam * 0.5f, 1e-8f), 1e2f);
        if (!worse)
          for (int i = 0; i < 7; ++i) s_best[i] = s_pose[i];
        s_best_chi2 = fminf(chi2, s_best_chi2);
        float H[6][6], b[6], step[6];
        int n = 0;
        for (int i = 0; i < 6; ++i)
          for (int j = 0; j <= i; ++j) {
            H[i][j] = tot[n];
            H[j][i] = tot[n];
            ++n;
          }
        for (int i = 0; i < 6; ++i) {
          b[i] = -tot[21 + i];
          H[i][i] = (H[i][i] + s_lam * H[i][i]) + 1e-9f;
        }
        solve_spd6(H, b, step);
        if (worse) {
          for (int i = 0; i < 7; ++i) s_pose[i] = s_best[i];
        } else {
          float np[7];
          retract(s_pose, step, np);
          for (int i = 0; i < 7; ++i) s_pose[i] = np[i];
        }
      }
      __syncthreads();
    }

    // final acceptance of the last proposed step
    {
      float acc[1] = {0.f};
      for (int e = tid; e < E; e += kThreads) {
        Edge ed;
        linearize(s_pose, pw, obs, stf[e], e, E, cam, ed);
        acc[0] += chi2_of(ed, w_info[e]) * inl[e] * (ed.pcz > 0.f ? 1.f : 0.f);
      }
      block_sum<1>(acc, part, tot);
      if (tid == 0 && !(tot[0] <= s_best_chi2))
        for (int i = 0; i < 7; ++i) s_pose[i] = s_best[i];
      __syncthreads();
    }
    // chi2 reclassification for the next round
    for (int e = tid; e < E; e += kThreads) {
      Edge ed;
      linearize(s_pose, pw, obs, stf[e], e, E, cam, ed);
      const float c2 = chi2_of(ed, w_info[e]);
      inl[e] = valid[e] * (ed.pcz > 0.f ? 1.f : 0.f) *
               (c2 <= chi2_th[e] ? 1.f : 0.f);
    }
    __syncthreads();
  }

  float acc[1] = {0.f};
  for (int e = tid; e < E; e += kThreads) {
    Edge ed;
    linearize(s_pose, pw, obs, stf[e], e, E, cam, ed);
    acc[0] += chi2_of(ed, w_info[e]) * inl[e];
  }
  block_sum<1>(acc, part, tot);
  if (tid < 7) out[tid] = s_pose[tid];
  if (tid == 0) out[7] = tot[0];
}

}  // namespace

extern "C" int aos2_pose_opt(const float* pose_in, const float* pw,
                             const float* obs, const float* aux, int E,
                             float fx, float fy, float cx, float cy, float bf,
                             int rounds, int iters, float* out, float* mask,
                             cudaStream_t stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  pose_opt_kernel<<<1, kThreads, 0, stream>>>(pose_in, pw, obs, aux, E, cam,
                                              rounds, iters, out, mask);
  return (int)cudaGetLastError();
}
