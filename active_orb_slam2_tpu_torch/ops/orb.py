"""ORB feature extraction: pyramid -> FAST -> distribute -> orient -> rBRIEF.

Port of ``active_orb_slam2_tpu/ops/orb.py``.  Same stages, same fixed
shapes (exactly ``n_features`` slots with a validity mask), same BRIEF
pattern (seed 1234) and the same 30 steering bins.

Where the JAX package works around the TPU, the port computes the
function instead: the ``[30, 961, 512]`` one-hot tap tensor becomes a
``[30, 512]`` flat-index table built from the same rotation and
rounding, and the taps are gathered directly.  On the card the whole
keypoint stage (patch gather, IC_Angle, blur, steered BRIEF, packing)
is one hand-written kernel launched once per frame for all levels
(``kernels/keypoints.py``); on the CPU it is :func:`keypoint_stage_torch`.

Descriptors are int32 with the same bits as the JAX package's uint32.
"""

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from active_orb_slam2_tpu_torch.config import OrbConfig
from active_orb_slam2_tpu_torch.ops.fast import bf16_round, fast_score_map, nms3x3
from active_orb_slam2_tpu_torch.ops.image import (
    gaussian_kernel1d, resize_bilinear)
from active_orb_slam2_tpu_torch.ops.patches import PATCH, extract_patches
from active_orb_slam2_tpu_torch.ops.topk import stable_topk
from active_orb_slam2_tpu_torch.utils import trace

HALF_PATCH = 15      # IC_Angle / BRIEF patch radius (reference PATCH_SIZE=31)
N_ANGLE_BINS = 30    # steering quantized to 12 degrees
PATCH_LO = 3         # 31x31 working window inside the 40x40 raw patch
BLUR_KSIZE = 7
BLUR_SIGMA = 2.0


class OrbFeatures(NamedTuple):
    """Fixed-size feature set for one frame (mask-valid slots)."""
    uv: torch.Tensor        # [N, 2] float32 — (x, y) at level-0 scale
    level: torch.Tensor     # [N] int32 — pyramid octave
    angle: torch.Tensor     # [N] float32 — orientation (radians)
    response: torch.Tensor  # [N] float32 — FAST corner score
    desc: torch.Tensor      # [N, 8] int32 — 256-bit rBRIEF (uint32 bits)
    valid: torch.Tensor     # [N] bool


@functools.lru_cache(maxsize=None)
def descriptor_pattern(seed: int = 1234):
    """Deterministic 256-pair BRIEF pattern [256, 4] int32 (x1, y1, x2,
    y2), clipped to the radius-15 disc."""
    rng = np.random.default_rng(seed)
    s = 2 * HALF_PATCH + 1
    p1 = rng.normal(0.0, s / 5.0, size=(256, 2))
    p2 = p1 + rng.normal(0.0, s / 10.0, size=(256, 2))

    def to_disc(p):
        n = np.linalg.norm(p, axis=-1, keepdims=True)
        return p * np.minimum(1.0, (HALF_PATCH - 1e-3) / np.maximum(n, 1e-9))

    pat = np.concatenate([to_disc(p1), to_disc(p2)], axis=1)
    return np.round(pat).astype(np.int32)


@functools.lru_cache(maxsize=None)
def moment_matrix():
    """[40, 40, 2] float32: the radius-15 disc's (x, y) coordinates placed
    at the 31x31 working window of the raw patch (IC_Angle moments)."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs * xs + ys * ys) <= r * r + 1
    G = np.zeros((PATCH, PATCH, 2), np.float32)
    sl = slice(PATCH_LO, PATCH_LO + 2 * r + 1)
    G[sl, sl, 0] = mask * xs
    G[sl, sl, 1] = mask * ys
    return G


@functools.lru_cache(maxsize=None)
def blur_matrix():
    """Banded [31, 40] float32 B such that ``B @ raw40 @ B.T`` is the
    7x7 sigma-2 Gaussian blur of the 31x31 working window."""
    g = gaussian_kernel1d(BLUR_KSIZE, BLUR_SIGMA)
    n = 2 * HALF_PATCH + 1
    B = np.zeros((n, PATCH), np.float32)
    for r in range(n):
        B[r, r:r + BLUR_KSIZE] = g
    return B


@functools.lru_cache(maxsize=None)
def tap_table(seed: int = 1234, nb: int = N_ANGLE_BINS):
    """[nb, 512] int32 flat indices into the blurred 31x31 window: for
    angle bin b, tap t (256 pairs x 2 endpoints) reads pixel
    ``table[b, t]``.  Same rotation and rounding as the JAX package's
    one-hot tap tensor."""
    pat = descriptor_pattern(seed).astype(np.float64)
    px = np.concatenate([pat[:, 0], pat[:, 2]])
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    n = 2 * HALF_PATCH + 1
    table = np.zeros((nb, 512), np.int32)
    for b in range(nb):
        th = (b + 0.5) * 2.0 * np.pi / nb
        c, s = np.cos(th), np.sin(th)
        rx = np.clip(np.round(c * px - s * py), -HALF_PATCH, HALF_PATCH)
        ry = np.clip(np.round(s * px + c * py), -HALF_PATCH, HALF_PATCH)
        table[b] = ((ry + HALF_PATCH) * n + (rx + HALF_PATCH)).astype(np.int32)
    return table


@functools.lru_cache(maxsize=None)
def device_constants(device: torch.device):
    """(moment [1600, 2], blur [31, 40], taps [30, 512], gauss [7]) on
    ``device``, made once per device."""
    return (torch.from_numpy(moment_matrix().reshape(-1, 2)).to(device),
            torch.from_numpy(blur_matrix()).to(device),
            torch.from_numpy(tap_table()).to(device),
            torch.from_numpy(gaussian_kernel1d(BLUR_KSIZE, BLUR_SIGMA))
            .to(device))


def level_sizes(h: int, w: int, cfg: OrbConfig):
    return [(max(int(round(h / cfg.scale_factor ** l)), 64),
             max(int(round(w / cfg.scale_factor ** l)), 64))
            for l in range(cfg.n_levels)]


def features_per_level(cfg: OrbConfig):
    """Geometric distribution of the feature budget over levels, as the
    reference ORBextractor constructor does."""
    f = 1.0 / cfg.scale_factor
    n0 = cfg.n_features * (1 - f) / (1 - f ** cfg.n_levels)
    ns = [int(round(n0 * f ** l)) for l in range(cfg.n_levels - 1)]
    ns.append(max(cfg.n_features - sum(ns), 0))
    return ns


def _cells(x, cs: int):
    """[H, W] -> [hc*wc, cs*cs] cells (zero-padded to whole cells)."""
    h, w = x.shape
    hc, wc = -(-h // cs), -(-w // cs)
    xp = F.pad(x, (0, wc * cs - w, 0, hc * cs - h))
    return xp.reshape(hc, cs, wc, cs).permute(0, 2, 1, 3).reshape(
        hc * wc, cs * cs), hc, wc


def detect_level(score, n_keep: int, cfg: OrbConfig):
    """Per-cell top-k candidates -> global top-n_keep by response.

    Returns (ys, xs, resp) int32/int32/float32 of length n_keep; resp 0
    marks empty slots.
    """
    cs = cfg.cell_size
    cells, hc, wc = _cells(score, cs)
    x = cells.clone()
    vals_l, idx_l = [], []
    for _ in range(cfg.cell_top_k):
        i = torch.argmax(x, dim=1, keepdim=True)      # first max wins
        vals_l.append(x.gather(1, i)[:, 0])
        idx_l.append(i[:, 0])
        x.scatter_(1, i, float("-inf"))
    vals = torch.stack(vals_l, dim=1)
    idx = torch.stack(idx_l, dim=1)
    cell_ids = torch.arange(hc * wc, device=score.device)[:, None]
    ys = (cell_ids // wc) * cs + idx // cs
    xs = (cell_ids % wc) * cs + idx % cs
    resp, take = stable_topk(vals.reshape(-1), n_keep)
    return (ys.reshape(-1)[take].to(torch.int32),
            xs.reshape(-1)[take].to(torch.int32), resp)


def threshold_fallback(score, cfg: OrbConfig):
    """Detect at iniThFAST; cells with no such corner fall back to
    minThFAST (``ComputeKeyPointsOctTree``)."""
    h, w = score.shape
    cs = cfg.cell_size
    pass_hi = score > cfg.ini_th_fast
    cells, hc, wc = _cells(pass_hi.to(torch.uint8), cs)
    cell_has_hi = cells.amax(1).bool().reshape(hc, 1, wc, 1).expand(
        hc, cs, wc, cs).reshape(hc * cs, wc * cs)[:h, :w]
    eligible = (score > cfg.min_th_fast) & (pass_hi | ~cell_has_hi)
    return torch.where(eligible, score, torch.zeros_like(score))


def angle_bins(angles):
    """Steering bin clip(floor(remainder(angle, 2 pi) / (2 pi / 30)))."""
    step = 2.0 * math.pi / N_ANGLE_BINS
    bins = torch.floor(torch.remainder(angles, 2.0 * math.pi) / step)
    return torch.clamp(bins.to(torch.int64), 0, N_ANGLE_BINS - 1)


def pack_bits(bits):
    """[K, 256] bool -> [K, 8] int32; pair 32*w + j goes to bit j of
    word w (the uint32 bits of the JAX package, held as int32)."""
    K = bits.shape[0]
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, device=bits.device))
    words = (bits.reshape(K, 8, 32).to(torch.int64) * weights).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def describe_patches(raw):
    """IC_Angle moments -> 7x7 blur -> bf16 rounding -> steered BRIEF
    gather -> packing, for raw patches [K, 40, 40].

    Returns (angles [K] float32, desc [K, 8] int32).
    """
    K = raw.shape[0]
    G, B, taps, _ = device_constants(raw.device)
    m = raw.reshape(K, -1) @ G                              # [K, 2]
    angles = torch.atan2(m[:, 1], m[:, 0])
    blurred = (B @ raw) @ B.T                               # [K, 31, 31]
    flat = bf16_round(blurred).reshape(K, -1)
    vals = flat.gather(1, taps[angle_bins(angles)].long())  # [K, 512]
    return angles, pack_bits(vals[:, :256] < vals[:, 256:])


def keypoint_stage_torch(levels, ys, xs, counts, pad: int):
    """Plain PyTorch keypoint stage for all levels of a frame: the
    clamped patch gather of each level, then :func:`describe_patches`.

    ``levels`` are the unpadded level images; ys / xs [K] hold level 0's
    ``counts[0]`` keypoints, then level 1's, and so on.
    """
    parts, start = [], 0
    for img, n in zip(levels, counts):
        parts.append(extract_patches(img, ys[start:start + n],
                                     xs[start:start + n], pad))
        start += n
    return describe_patches(torch.cat(parts))


def keypoint_stage(levels, ys, xs, counts, pad: int):
    """IC_Angle + steered BRIEF for all keypoints of all levels.

    CUDA tensors go through the hand-written kernel in one launch; CPU
    tensors through :func:`keypoint_stage_torch`.
    """
    if ys.is_cuda:
        from active_orb_slam2_tpu_torch.kernels.keypoints import (
            keypoint_stage_cuda)
        _, _, taps, gauss = device_constants(ys.device)
        return keypoint_stage_cuda(levels, ys, xs, counts, pad, taps, gauss)
    return keypoint_stage_torch(levels, ys, xs, counts, pad)


@functools.lru_cache(maxsize=None)
def level_columns(n_per_level: tuple, scale_factor: float,
                  device: torch.device):
    """(level [N] int32, scale [N] float32) of the N feature slots, made
    once per device; scale is float32(scale_factor ** level), the factor
    the JAX package multiplies each level's coordinates by."""
    lv = np.repeat(np.arange(len(n_per_level)), n_per_level)
    scale = np.array([scale_factor ** int(l) for l in lv], np.float32)
    return (torch.from_numpy(lv.astype(np.int32)).to(device),
            torch.from_numpy(scale).to(device))


class ExtractorStages(NamedTuple):
    """The extractor of one image size in its three stages:

    * ``detect(img) -> (levels, ys, xs, resp)``: the pyramid, FAST with
      NMS and the threshold fallback, and the cell top-k of every level;
      the keypoints of all levels concatenated, level 0's first;
    * ``describe(levels, ys, xs) -> (angles, desc)``: the keypoint stage
      of all levels (on the card one launch of K2);
    * ``features(ys, xs, resp, angles, desc) -> OrbFeatures``.
    """
    detect: Callable
    describe: Callable
    features: Callable


def build_extractor_stages(cfg: OrbConfig, height: int, width: int
                           ) -> ExtractorStages:
    """The stages of :func:`build_extractor` for this size.  ``detect``
    opens the tracer's ``frame.pyramid``, ``frame.fast`` and
    ``frame.topk`` spans (once a level)."""
    sizes = level_sizes(height, width, cfg)
    n_per_level = features_per_level(cfg)

    def detect(img):
        levels, ys, xs, resp = [], [], [], []
        for (h, w), n_l in zip(sizes, n_per_level):
            # each level is resized straight from level 0, as in the
            # JAX package
            with trace.span("frame.pyramid"):
                level_img = resize_bilinear(img, h, w)
            with trace.span("frame.fast"):
                score = threshold_fallback(
                    nms3x3(fast_score_map(level_img)), cfg)
            with trace.span("frame.topk"):
                y, x, r = detect_level(score, n_l, cfg)
            levels.append(level_img)
            ys.append(y)
            xs.append(x)
            resp.append(r)
        return levels, torch.cat(ys), torch.cat(xs), torch.cat(resp)

    def describe(levels, ys, xs):
        return keypoint_stage(levels, ys, xs, n_per_level, cfg.pad)

    def features(ys, xs, resp, ang, desc):
        level, scale = level_columns(tuple(n_per_level), cfg.scale_factor,
                                     ys.device)
        uv = torch.stack([xs.to(torch.float32) * scale,
                          ys.to(torch.float32) * scale], dim=-1)
        return OrbFeatures(uv=uv, level=level, angle=ang, response=resp,
                           desc=desc, valid=resp > 0.0)

    return ExtractorStages(detect, describe, features)


def build_extractor(cfg: OrbConfig, height: int, width: int):
    """Return ``image [H, W] float32 -> OrbFeatures`` for this size: the
    three stages of :func:`build_extractor_stages`, the keypoint stage
    in the tracer's ``frame.describe`` span."""
    stages = build_extractor_stages(cfg, height, width)

    def extract(img):
        levels, ys, xs, resp = stages.detect(img)
        with trace.span("frame.describe"):
            ang, desc = stages.describe(levels, ys, xs)
        return stages.features(ys, xs, resp, ang, desc)

    return extract
