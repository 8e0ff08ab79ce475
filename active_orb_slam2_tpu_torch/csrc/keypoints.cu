// Keypoint stage kernel: patch gather, IC_Angle, 7x7 blur, steered BRIEF.
//
// Replaces the Pallas kernel of active_orb_slam2_tpu/ops/patches.py
// (_window_call, wrapped by extract_patches) and fuses what
// active_orb_slam2_tpu/ops/orb.py::_keypoint_stage does with the patch.
// On the TPU the patch came out of a tile-aligned DMA window cut with two
// one-hot matmuls, and the BRIEF taps out of a [30, 961, 512] one-hot
// contraction.  Here a block simply loads its 40x40 patch and gathers the
// taps from shared memory.
//
// What bounds it on Hopper: one frame has ~1k keypoints over 8 levels,
// each needing a 6.4 KB patch read and ~30 kFLOP, so the work is tiny and
// the kernel is bound by latency (load the patch, three block barriers,
// two small reductions), not by bandwidth or arithmetic.  The design keeps
// everything for one keypoint in one block's shared memory (~15 KB), with
// one block per keypoint so the ~100-220 keypoints of a level spread over
// the SMs, and packs the 256 compares with one __ballot_sync per warp.
//
// Semantics follow the JAX package exactly:
//   y0 = clip(y + pad - 18, 0, Hp - 40), likewise x0;
//   patch = bf16(img)[y0:y0+40, x0:x0+40];
//   moments over the radius-15 disc (x^2 + y^2 <= 226) of the 31x31
//   window at offset 3, angle = atan2(m_y, m_x);
//   blur = B @ patch @ B^T with the 7-tap sigma-2 Gaussian, rounded to bf16;
//   bin = clip(floor(remainder(angle, 2 pi) / (2 pi / 30)), 0, 29);
//   bit 32 w + j of the descriptor = blur[taps[bin][p]] < blur[taps[bin][256 + p]]
//   with p = 32 w + j, stored as bit j of word w.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kPatch = 40;
constexpr int kWin = 31;        // IC_Angle / BRIEF window
constexpr int kHalf = 15;
constexpr int kLo = 3;          // window offset inside the patch
constexpr int kTaps = 7;        // Gaussian taps
constexpr int kOffset = 18;     // patch starts 18 px before the keypoint
constexpr int kBins = 30;
constexpr int kThreads = 256;   // one thread per BRIEF pair
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
keypoints_kernel(const float* __restrict__ img, int hp, int wp,
                 const int* __restrict__ ys, const int* __restrict__ xs,
                 int pad, const int* __restrict__ taps,
                 const float* __restrict__ gauss,
                 float* __restrict__ angle_out, int* __restrict__ desc_out) {
  __shared__ float raw[kPatch][kPatch + 1];
  __shared__ float vert[kWin][kPatch + 1];   // vertically blurred rows
  __shared__ float blur[kWin * kWin];        // bf16-rounded blurred window
  __shared__ float red[2][kWarps];
  __shared__ int s_bin;

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int y0 = min(max(ys[k] + pad - kOffset, 0), hp - kPatch);
  const int x0 = min(max(xs[k] + pad - kOffset, 0), wp - kPatch);

  for (int i = tid; i < kPatch * kPatch; i += kThreads) {
    const int r = i / kPatch, c = i % kPatch;
    raw[r][c] = bf16_round(img[(size_t)(y0 + r) * wp + x0 + c]);
  }
  __syncthreads();

  // intensity-centroid moments over the disc
  float mx = 0.f, my = 0.f;
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int dy = i / kWin - kHalf, dx = i % kWin - kHalf;
    if (dx * dx + dy * dy <= kHalf * kHalf + 1) {
      const float v = raw[kLo + kHalf + dy][kLo + kHalf + dx];
      mx += v * (float)dx;
      my += v * (float)dy;
    }
  }
  mx = warp_sum(mx);
  my = warp_sum(my);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = mx;
    red[1][tid >> 5] = my;
  }

  // separable blur, rows first as in B @ patch @ B^T: vert = B @ patch
  float g[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) g[j] = gauss[j];
  for (int i = tid; i < kWin * (kWin + kTaps - 1); i += kThreads) {
    const int r = i / (kWin + kTaps - 1), q = i % (kWin + kTaps - 1);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) s += g[j] * raw[r + j][q];
    vert[r][q] = s;
  }
  __syncthreads();

  if (tid == 0) {
    float sx = 0.f, sy = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sx += red[0][w];
      sy += red[1][w];
    }
    const float angle = atan2f(sy, sx);
    angle_out[k] = angle;
    const float two_pi = 6.28318530717958647692f;
    float m = fmodf(angle, two_pi);
    if (m < 0.f) m += two_pi;
    const int bin = (int)floorf(m / (float)(6.28318530717958647692 / kBins));
    s_bin = min(max(bin, 0), kBins - 1);
  }
  // then columns: blur = vert @ B^T
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int r = i / kWin, c = i % kWin;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) s += g[j] * vert[r][c + j];
    blur[i] = bf16_round(s);
  }
  __syncthreads();

  const int* t = taps + s_bin * 512;
  const bool bit = blur[t[tid]] < blur[t[256 + tid]];
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((tid & 31) == 0) desc_out[(size_t)k * 8 + (tid >> 5)] = (int)word;
}

}  // namespace

extern "C" int aos2_keypoints(const float* img, int hp, int wp, const int* ys,
                              const int* xs, int k, int pad, const int* taps,
                              const float* gauss, float* angle_out,
                              int* desc_out, cudaStream_t stream) {
  if (k <= 0) return 0;
  keypoints_kernel<<<k, kThreads, 0, stream>>>(img, hp, wp, ys, xs, pad, taps,
                                               gauss, angle_out, desc_out);
  return (int)cudaGetLastError();
}
