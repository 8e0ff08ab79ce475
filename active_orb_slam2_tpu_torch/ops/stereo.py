"""Stereo matching: left/right ORB association and subpixel SAD refinement.

Port of ``active_orb_slam2_tpu/ops/stereo.py`` (``Frame::
ComputeStereoMatches``): a masked [N_l, N_r] Hamming matrix with the
row-band, disparity and level gates, then an 11-tap SAD slide of an
11x11 left patch along an 11x21 right strip and a parabola fit.  The
JAX package cuts the patches with ``dynamic_slice`` from edge-padded
images; here they are gathered by clamped indices, which read the same
pixels.  Every step is a fixed-shape tensor operation, so the function
never waits on the card.

The outlier filter keeps the JAX package's arithmetic: it takes
``jnp.median`` of the best SADs with NaN where a feature is not
matched, and ``jnp.median`` propagates NaN, so the 2.1 x median bound
is infinite, and the filter inert, unless every feature matched
(ROADMAP queue 3, item k).  :func:`jnp_median` reproduces it.
"""

import math

import torch

from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.ops.matching import hamming_matrix

PATCH = 5      # SAD half-window (11 x 11)
SLIDE = 5      # +-5 px search


def jnp_median(x):
    """``jnp.median`` of a 1-D tensor: NaN if any entry is NaN, else the
    linear interpolation at position 0.5 (n - 1) of the sorted values
    (the mean of the two middle values for even n)."""
    n = x.shape[0]
    q = 0.5 * (n - 1)
    lo, hi = math.floor(q), math.ceil(q)
    w_hi = q - lo
    srt = torch.sort(x).values
    med = srt[lo] * (1.0 - w_hi) + srt[hi] * w_hi
    return torch.where(torch.isnan(x).any(), float("nan"), med)


def _gather_window(img, y, x, half_h: int, half_w: int):
    """[N, 2 half_h + 1, 2 half_w + 1] windows of ``img`` [H, W] centred
    at integer (y, x) [N], edge-replicated past the borders."""
    h, w = img.shape
    dy = torch.arange(-half_h, half_h + 1, device=img.device)
    dx = torch.arange(-half_w, half_w + 1, device=img.device)
    rows = torch.clamp(y[:, None] + dy, 0, h - 1)
    cols = torch.clamp(x[:, None] + dx, 0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def compute_stereo_matches(cam: CameraParams, feats_l, feats_r, img_l, img_r,
                           min_disp: float = 0.1, max_dist: float = 100.0):
    """Match left to right, refine subpixel; returns (ur [N], depth [N]),
    -1 and 0 where a left feature has no accepted match.

    feats_l / feats_r: OrbFeatures of the rectified pair; img_l / img_r:
    the float32 grayscale images for the SAD refinement.
    """
    # disparity ceiling: the reference's maxD = bf / minZ with minZ = the
    # baseline, so disp <= fx
    max_disp = cam.fx
    uv_l, uv_r = feats_l.uv, feats_r.uv
    d = hamming_matrix(feats_l.desc, feats_r.desc, feats_l.valid,
                       feats_r.valid)
    # row band: |v_l - v_r| <= 2 * scale of the right keypoint's level
    band = 2.0 * torch.pow(1.2, feats_r.level.to(torch.float32))
    row_ok = (uv_l[:, 1:2] - uv_r[None, :, 1]).abs() <= band[None, :]
    disp = uv_l[:, 0:1] - uv_r[None, :, 0]
    disp_ok = (disp > min_disp) & (disp < max_disp)
    lv_ok = (feats_l.level[:, None] - feats_r.level[None, :]).abs() <= 1
    d = torch.where(row_ok & disp_ok & lv_ok, d, 1e9)
    best = torch.argmin(d, dim=1)                        # first min wins
    matched = d.gather(1, best[:, None])[:, 0] <= max_dist

    # subpixel SAD refinement at level 0 around the matched column
    h, w = img_l.shape

    def pixel(v, n):
        # torch.round is half-to-even, as jnp.round
        return torch.clamp(torch.round(v).long(), 0, n - 1)

    xr0 = pixel(uv_r[best, 0], w)
    pl = _gather_window(img_l, pixel(uv_l[:, 1], h), pixel(uv_l[:, 0], w),
                        PATCH, PATCH)                      # [N, 11, 11]
    strip = _gather_window(img_r, pixel(uv_r[best, 1], h), xr0, PATCH,
                           PATCH + SLIDE)                  # [N, 11, 21]
    # SAD of strip columns [s, s + 11) against the left patch, s = 0..10
    seg = strip.unfold(2, 2 * PATCH + 1, 1)               # [N, 11, 11, 11]
    sads = (seg - pl[:, :, None, :]).abs().sum((1, 3))     # [N, 11]

    k_c = torch.clamp(torch.argmin(sads, dim=1), 1, 2 * SLIDE - 1)
    s0, s1, s2 = (sads.gather(1, (k_c + o)[:, None])[:, 0] for o in (-1, 0, 1))
    denom = torch.clamp(s0 + s2 - 2 * s1, min=1e-6)
    delta = torch.clamp(0.5 * (s0 - s2) / denom, -1.0, 1.0)
    ur = xr0.to(torch.float32) + (k_c - SLIDE) + delta

    disparity = uv_l[:, 0] - ur
    ok = matched & (disparity > min_disp) & (disparity < max_disp)
    # SAD outlier filter (the reference's 1.5 * 1.4 * median)
    med = jnp_median(torch.where(ok, s1, float("nan")))
    med = torch.where(torch.isnan(med), float("inf"), med)
    ok = ok & (s1 <= 2.1 * med)
    # bf / disparity as one division, as in the JAX package: PyTorch
    # turns a Python scalar over a tensor into a reciprocal times the
    # scalar, two roundings
    disparity = torch.clamp(disparity, min=1e-6)
    depth = torch.where(ok, torch.full_like(disparity, cam.bf) / disparity,
                        0.0)
    return torch.where(ok, ur, -1.0), depth
