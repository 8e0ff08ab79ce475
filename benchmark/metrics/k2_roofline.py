"""K2 (``csrc/keypoints.cu``, the keypoint stage of every level of an
image in one launch): the least time the card could take (the larger of
its FLOP over 67 TFLOP/s and its bytes over 3.35 TB/s) over its device
time, in %, a launch's mean over the traced stretch.

Counted from each launch's arguments as PERF.md's kernel table counts
them (from ``csrc/keypoints.cu``): per keypoint the moments over the
717-pixel disc (4 FLOP each), the 31x37 and 31x31 7-tap blurs (14 each)
and 256 compares; bytes are the level pixels the 40x40 patches cover,
each read once, the keypoints, the tap table and the outputs.
"""

import torch

from benchmark.harness import trace

PEAK_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
FLOP_KEYPOINT = 717 * 4 + (31 * 37 + 31 * 31) * 14 + 256
PATCH, PATCH_OFFSET = 40, 18


def _patch_index(v, n, pad):
    v0 = torch.clamp(v.long() + (pad - PATCH_OFFSET), 0,
                     n + 2 * pad - PATCH) - pad
    return torch.clamp(v0[:, None] + torch.arange(PATCH, device=v.device),
                       0, n - 1)


def flops_bytes(args):
    """(FLOP, bytes) of one launch with the entry's arguments (levels,
    ys, xs, counts, pad, taps, gauss)."""
    levels, ys, xs, counts, pad = args[:5]
    pixels, start = 0, 0
    for img, n in zip(levels, counts):
        h, w = img.shape
        rows = _patch_index(ys[start:start + n], h, pad)
        cols = _patch_index(xs[start:start + n], w, pad)
        pixels += int(torch.unique(rows[:, :, None] * w
                                   + cols[:, None, :]).numel())
        start += n
    K = ys.shape[0]
    return K * FLOP_KEYPOINT, \
        4 * pixels + 8 * K + 4 * (30 * 512 + 7) + 4 * K + 32 * K


def read(run):
    p = run.profile
    if not p or not p.get("k2_args"):
        return None
    us = trace.kernel_us(p, "keypoints_kernel")
    if not us or not sum(us):
        return None
    least = sum(max(f / PEAK_FLOPS, b / PEAK_BYTES_S)
                for f, b in map(flops_bytes, p["k2_args"])) \
        / len(p["k2_args"])
    return 100.0 * least / (sum(us) / len(us) / 1e6)
