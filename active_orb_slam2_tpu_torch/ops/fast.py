"""FAST-9/16 corner score map and 3x3 non-maximum suppression.

Port of ``active_orb_slam2_tpu/ops/fast.py``.  For every pixel the score
is the largest threshold at which it is still a FAST-9/16 corner:

  score(p) = max over 9-long arcs A of  min_{i in A} |I[p+c_i] - I[p]|

over arcs that are entirely brighter or darker.  The JAX package takes
the ring differences in bfloat16; the port rounds them the same way.
At level 0 the pixels are integers and the rounding is exact; at the
resized levels it is not, so it has to be emulated for parity.
"""

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock.
CIRCLE_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9/16


def bf16_round(x):
    """Round float32 values to the nearest bfloat16, kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _arc_extrema(x):
    """Per-start min and max over 9 consecutive ring entries (circular)
    of x [16, H, W], by log-doubling."""
    def doubling(v, op):
        m2 = op(v, torch.roll(v, -1, 0))
        m4 = op(m2, torch.roll(m2, -2, 0))
        m8 = op(m4, torch.roll(m4, -4, 0))
        return op(m8, torch.roll(v, -8, 0))
    return doubling(x, torch.minimum), doubling(x, torch.maximum)


def fast_score_map(img, border: int = 3):
    """Corner score [H, W] float32 for an [H, W] float32 image; zero
    where no corner and on the ``border`` (the ring would wrap)."""
    b = bf16_round(img)
    ring = torch.stack([torch.roll(b, (-int(dy), -int(dx)), (0, 1))
                        for dy, dx in CIRCLE_OFFSETS])
    d = bf16_round(ring - b[None])
    amin, amax = _arc_extrema(d)
    score = torch.maximum(amin.amax(0), (-amax).amax(0))
    score = torch.clamp(score, min=0.0)
    h, w = img.shape
    interior = torch.zeros_like(score, dtype=torch.bool)
    interior[border:h - border, border:w - border] = True
    return torch.where(interior, score, torch.zeros_like(score))


def nms3x3(score):
    """3x3 non-maximum suppression: keep a score where it equals the
    local maximum and is positive."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= pooled) & (score > 0.0), score,
                       torch.zeros_like(score))
