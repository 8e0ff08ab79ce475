"""The frame pipeline in plain PyTorch: pyramid, FAST-9/16 with 3x3
non-maximum suppression and the iniThFAST / minThFAST fallback, per-cell
and per-level top-k, IC_Angle and steered rBRIEF, keypoint undistortion,
the depth of an RGB-D keypoint, and stereo matching with SAD refinement.

A frozen copy of what the program computes in ``ops/{image, fast, orb,
patches, topk, undistort, stereo, matching}.py`` and ``models/frame.py``
with the keypoint stage's plain version (where the program launches its
keypoint kernel), taken when the benchmark was written.  ``dtype`` is the
precision of the arithmetic on image values: float32 is the program's;
bfloat16 is the control, one precision below.
"""

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15
N_ANGLE_BINS = 30
PATCH = 40
PATCH_OFFSET = 18
PATCH_LO = 3
BLUR_KSIZE = 7
BLUR_SIGMA = 2.0
SAD_HALF = 5
SAD_SLIDE = 5
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)


class Frame(NamedTuple):
    uv: torch.Tensor        # [N, 2] undistorted keypoints
    level: torch.Tensor     # [N] int32
    angle: torch.Tensor     # [N]
    desc: torch.Tensor      # [N, 8] int32
    valid: torch.Tensor     # [N] bool
    ur: torch.Tensor        # [N] virtual right x (-1 none)
    depth: torch.Tensor     # [N] metres (0 none)


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------------ tables

@functools.lru_cache(maxsize=None)
def gauss1d(ksize=BLUR_KSIZE, sigma=BLUR_SIGMA):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_weights(n_in, n_out):
    scale = n_in / n_out
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(centers).astype(np.int64)
    frac = (centers - lo).astype(np.float32)
    w = np.zeros((n_in, n_out), np.float32)
    w[np.clip(lo, 0, n_in - 1), np.arange(n_out)] += 1.0 - frac
    w[np.clip(lo + 1, 0, n_in - 1), np.arange(n_out)] += frac
    return w


@functools.lru_cache(maxsize=None)
def brief_pattern(seed=1234):
    rng = np.random.default_rng(seed)
    s = 2 * HALF_PATCH + 1
    p1 = rng.normal(0.0, s / 5.0, size=(256, 2))
    p2 = p1 + rng.normal(0.0, s / 10.0, size=(256, 2))

    def to_disc(p):
        n = np.linalg.norm(p, axis=-1, keepdims=True)
        return p * np.minimum(1.0, (HALF_PATCH - 1e-3) / np.maximum(n, 1e-9))

    return np.round(np.concatenate([to_disc(p1), to_disc(p2)], 1)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def moments():
    r = HALF_PATCH
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs * xs + ys * ys) <= r * r + 1
    G = np.zeros((PATCH, PATCH, 2), np.float32)
    sl = slice(PATCH_LO, PATCH_LO + 2 * r + 1)
    G[sl, sl, 0] = mask * xs
    G[sl, sl, 1] = mask * ys
    return G.reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def blur_matrix():
    g = gauss1d()
    n = 2 * HALF_PATCH + 1
    B = np.zeros((n, PATCH), np.float32)
    for r in range(n):
        B[r, r:r + BLUR_KSIZE] = g
    return B


@functools.lru_cache(maxsize=None)
def taps():
    pat = brief_pattern().astype(np.float64)
    px = np.concatenate([pat[:, 0], pat[:, 2]])
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    n = 2 * HALF_PATCH + 1
    table = np.zeros((N_ANGLE_BINS, 512), np.int32)
    for b in range(N_ANGLE_BINS):
        th = (b + 0.5) * 2.0 * np.pi / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        rx = np.clip(np.round(c * px - s * py), -HALF_PATCH, HALF_PATCH)
        ry = np.clip(np.round(s * px + c * py), -HALF_PATCH, HALF_PATCH)
        table[b] = ((ry + HALF_PATCH) * n + (rx + HALF_PATCH)).astype(np.int32)
    return table


def level_sizes(h, w, orb):
    return [(max(int(round(h / orb.scale_factor ** l)), 64),
             max(int(round(w / orb.scale_factor ** l)), 64))
            for l in range(orb.n_levels)]


def features_per_level(orb):
    f = 1.0 / orb.scale_factor
    n0 = orb.n_features * (1 - f) / (1 - f ** orb.n_levels)
    ns = [int(round(n0 * f ** l)) for l in range(orb.n_levels - 1)]
    ns.append(max(orb.n_features - sum(ns), 0))
    return ns


# ------------------------------------------------------------ the stages

def resize(img, h, w, dtype):
    if tuple(img.shape) == (h, w):
        return img
    wy = torch.from_numpy(resize_weights(img.shape[0], h)).to(img.device, dtype)
    wx = torch.from_numpy(resize_weights(img.shape[1], w)).to(img.device, dtype)
    return (wy.T @ img) @ wx


def fast_score(img):
    """FAST-9/16 score of a level image; the ring differences rounded to
    bfloat16 as the program rounds them."""
    b = bf16(img.float())
    ring = torch.stack([torch.roll(b, (-int(dy), -int(dx)), (0, 1))
                        for dy, dx in CIRCLE])
    d = bf16(ring - b[None])

    def arc(v, op):
        m2 = op(v, torch.roll(v, -1, 0))
        m4 = op(m2, torch.roll(m2, -2, 0))
        m8 = op(m4, torch.roll(m4, -4, 0))
        return op(m8, torch.roll(v, -8, 0))

    amin, amax = arc(d, torch.minimum), arc(d, torch.maximum)
    score = torch.clamp(torch.maximum(amin.amax(0), (-amax).amax(0)), min=0.0)
    h, w = img.shape
    inner = torch.zeros_like(score, dtype=torch.bool)
    inner[3:h - 3, 3:w - 3] = True
    score = torch.where(inner, score, torch.zeros_like(score))
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= pooled) & (score > 0.0), score,
                       torch.zeros_like(score))


def _cells(x, cs):
    h, w = x.shape
    hc, wc = -(-h // cs), -(-w // cs)
    xp = F.pad(x, (0, wc * cs - w, 0, hc * cs - h))
    return xp.reshape(hc, cs, wc, cs).permute(0, 2, 1, 3).reshape(
        hc * wc, cs * cs), hc, wc


def fallback(score, orb):
    h, w = score.shape
    cs = orb.cell_size
    hi = score > orb.ini_th_fast
    cells, hc, wc = _cells(hi.to(torch.uint8), cs)
    has_hi = cells.amax(1).bool().reshape(hc, 1, wc, 1).expand(
        hc, cs, wc, cs).reshape(hc * cs, wc * cs)[:h, :w]
    ok = (score > orb.min_th_fast) & (hi | ~has_hi)
    return torch.where(ok, score, torch.zeros_like(score))


def detect(score, n_keep, orb):
    cs = orb.cell_size
    cells, hc, wc = _cells(score, cs)
    x = cells.clone()
    vals, idx = [], []
    for _ in range(orb.cell_top_k):
        i = torch.argmax(x, dim=1, keepdim=True)
        vals.append(x.gather(1, i)[:, 0])
        idx.append(i[:, 0])
        x.scatter_(1, i, float("-inf"))
    vals, idx = torch.stack(vals, 1), torch.stack(idx, 1)
    cid = torch.arange(hc * wc, device=score.device)[:, None]
    ys = (cid // wc) * cs + idx // cs
    xs = (cid % wc) * cs + idx % cs
    srt, take = torch.sort(vals.reshape(-1), descending=True, stable=True)
    take = take[:n_keep]
    return (ys.reshape(-1)[take].to(torch.int32),
            xs.reshape(-1)[take].to(torch.int32), srt[:n_keep])


def _patch_index(v, n, pad):
    v0 = torch.clamp(v.long() + (pad - PATCH_OFFSET), 0,
                     n + 2 * pad - PATCH) - pad
    return torch.clamp(v0[:, None] + torch.arange(PATCH, device=v.device),
                       0, n - 1)


def describe(levels, ys, xs, counts, pad, dtype):
    """IC_Angle and steered rBRIEF of every keypoint of every level."""
    parts, start = [], 0
    for img, n in zip(levels, counts):
        h, w = img.shape
        rows = _patch_index(ys[start:start + n], h, pad)[:, :, None]
        cols = _patch_index(xs[start:start + n], w, pad)[:, None, :]
        parts.append(bf16(img.float()).to(dtype)[rows, cols])
        start += n
    raw = torch.cat(parts)
    K = raw.shape[0]
    dev = raw.device
    G = torch.from_numpy(moments()).to(dev, dtype)
    B = torch.from_numpy(blur_matrix()).to(dev, dtype)
    m = (raw.reshape(K, -1) @ G).float()
    ang = torch.atan2(m[:, 1], m[:, 0])
    flat = bf16(((B @ raw) @ B.T).float()).reshape(K, -1)
    step = 2.0 * math.pi / N_ANGLE_BINS
    bins = torch.clamp(torch.floor(torch.remainder(ang, 2.0 * math.pi) / step)
                       .to(torch.int64), 0, N_ANGLE_BINS - 1)
    tap = torch.from_numpy(taps()).to(dev)
    vals = flat.gather(1, tap[bins].long())
    bits = vals[:, :256] < vals[:, 256:]
    wts = torch.bitwise_left_shift(torch.ones(32, dtype=torch.int64,
                                              device=dev),
                                   torch.arange(32, device=dev))
    words = (bits.reshape(K, 8, 32).to(torch.int64) * wts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return ang, words.to(torch.int32)


def extract(img, orb, dtype=torch.float32):
    """(uv [N, 2], level, angle, desc, valid) of an [H, W] image."""
    img = img.to(torch.float32).to(dtype)
    sizes = level_sizes(img.shape[0], img.shape[1], orb)
    counts = features_per_level(orb)
    levels, ys, xs, resp = [], [], [], []
    for (h, w), n in zip(sizes, counts):
        lv = resize(img, h, w, dtype)
        y, x, r = detect(fallback(fast_score(lv), orb), n, orb)
        levels.append(lv)
        ys.append(y)
        xs.append(x)
        resp.append(r)
    ys, xs, resp = torch.cat(ys), torch.cat(xs), torch.cat(resp)
    ang, desc = describe(levels, ys, xs, counts, orb.pad, dtype)
    lv_np = np.repeat(np.arange(len(counts)), counts)
    level = torch.from_numpy(lv_np.astype(np.int32)).to(img.device)
    scale = torch.from_numpy(np.array(
        [orb.scale_factor ** int(l) for l in lv_np], np.float32)).to(
            img.device)
    uv = torch.stack([xs.float() * scale, ys.float() * scale], -1)
    return uv, level, ang, desc, resp > 0.0


def undistort(cam, uv, iters=8):
    k1, k2, p1, p2, k3 = (float(v) for v in cam.dist)
    x_d = (uv[:, 0] - cam.cx) / torch.full_like(uv[:, 0], cam.fx)
    y_d = (uv[:, 1] - cam.cy) / torch.full_like(uv[:, 1], cam.fy)
    x, y = x_d, y_d
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x_d - dx) / radial
        y = (y_d - dy) / radial
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], -1)


def rgbd_frame(cam, orb, gray, depth_mm, dtype=torch.float32):
    """The frame of an RGB-D pair: gray [H, W] uint8, depth [H, W] uint16
    millimetres."""
    raw, level, ang, desc, valid = extract(gray, orb, dtype)
    uv = undistort(cam, raw) if any(v != 0.0 for v in cam.dist) else raw
    dmap = depth_mm.to(torch.float32) * torch.tensor(1e-3, dtype=torch.float32)
    h, w = dmap.shape
    xi = torch.clamp(torch.round(raw[:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(raw[:, 1]).long(), 0, h - 1)
    d = dmap[yi, xi]
    has = (d > 0) & valid
    dp = torch.clamp(d, min=1e-6)
    ur = torch.where(has, uv[:, 0] - torch.full_like(dp, cam.bf) / dp, -1.0)
    return Frame(uv, level, ang, desc, valid, ur, torch.where(has, d, 0.0))


def _hamming(da, db, va, vb):
    sh = torch.arange(32, dtype=torch.int32, device=da.device)

    def pm(d):
        return 2.0 * ((d[:, :, None] >> sh) & 1).reshape(d.shape[0], 256) \
            .float() - 1.0

    d = 0.5 * (256.0 - pm(da) @ pm(db).T)
    d = torch.where(va[:, None], d, 1e9)
    return torch.where(vb[None, :], d, 1e9)


def _window(img, y, x, hh, hw):
    h, w = img.shape
    rows = torch.clamp(y[:, None] + torch.arange(-hh, hh + 1, device=img.device),
                       0, h - 1)
    cols = torch.clamp(x[:, None] + torch.arange(-hw, hw + 1, device=img.device),
                       0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def _median_nan(x):
    n = x.shape[0]
    q = 0.5 * (n - 1)
    lo, hi = math.floor(q), math.ceil(q)
    srt = torch.sort(x).values
    med = srt[lo] * (1.0 - (q - lo)) + srt[hi] * (q - lo)
    return torch.where(torch.isnan(x).any(), float("nan"), med)


def stereo_frame(cam, orb, left, right, dtype=torch.float32):
    """The frame of a rectified pair (uint8 [H, W] each)."""
    uvl, lvl, ang, desc, vl = extract(left, orb, dtype)
    uvr, lvr, _, descr, vr = extract(right, orb, dtype)
    il = left.to(torch.float32).to(dtype)
    ir = right.to(torch.float32).to(dtype)
    d = _hamming(desc, descr, vl, vr)
    band = 2.0 * torch.pow(1.2, lvr.float())
    row_ok = (uvl[:, 1:2] - uvr[None, :, 1]).abs() <= band[None, :]
    disp = uvl[:, 0:1] - uvr[None, :, 0]
    disp_ok = (disp > 0.1) & (disp < cam.fx)
    lv_ok = (lvl[:, None] - lvr[None, :]).abs() <= 1
    d = torch.where(row_ok & disp_ok & lv_ok, d, 1e9)
    best = torch.argmin(d, dim=1)
    matched = d.gather(1, best[:, None])[:, 0] <= 100.0
    h, w = il.shape

    def px(v, n):
        return torch.clamp(torch.round(v).long(), 0, n - 1)

    xr0 = px(uvr[best, 0], w)
    pl = _window(il, px(uvl[:, 1], h), px(uvl[:, 0], w), SAD_HALF, SAD_HALF)
    strip = _window(ir, px(uvr[best, 1], h), xr0, SAD_HALF,
                    SAD_HALF + SAD_SLIDE)
    seg = strip.unfold(2, 2 * SAD_HALF + 1, 1)
    sads = (seg - pl[:, :, None, :]).abs().sum((1, 3)).float()
    k_c = torch.clamp(torch.argmin(sads, dim=1), 1, 2 * SAD_SLIDE - 1)
    s0, s1, s2 = (sads.gather(1, (k_c + o)[:, None])[:, 0] for o in (-1, 0, 1))
    den = torch.clamp(s0 + s2 - 2 * s1, min=1e-6)
    delta = torch.clamp(0.5 * (s0 - s2) / den, -1.0, 1.0)
    ur = xr0.float() + (k_c - SAD_SLIDE) + delta
    disparity = uvl[:, 0] - ur
    ok = matched & (disparity > 0.1) & (disparity < cam.fx)
    med = _median_nan(torch.where(ok, s1, float("nan")))
    med = torch.where(torch.isnan(med), float("inf"), med)
    ok = ok & (s1 <= 2.1 * med)
    disparity = torch.clamp(disparity, min=1e-6)
    depth = torch.where(ok, torch.full_like(disparity, cam.bf) / disparity, 0.0)
    ur = torch.where(ok, ur, -1.0)
    return Frame(uvl, lvl, ang, desc, vl, torch.where(vl, ur, -1.0),
                 torch.where(vl, depth, 0.0))
