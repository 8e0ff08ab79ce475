"""Keypoint patch gather: the plain PyTorch version of what the Pallas
kernel of ``active_orb_slam2_tpu/ops/patches.py`` computes.

The TPU kernel DMAs a tile-aligned 56-row window around each keypoint
of the replicate-padded level image and cuts the 40x40 patch out of it
with two bf16 one-hot matmuls.  Its net function is a slice of the
bf16-rounded padded level image, and replicate padding is a clamp of
the indices, so the port reads the unpadded level:

  patch[k, r, c] = bf16(level)[clip(y0 + r - pad, 0, h - 1),
                               clip(x0 + c - pad, 0, w - 1)],
  y0 = clip(y + pad - 18, 0, h + 2 pad - 40), and likewise for x.

On the card this gather is fused into the keypoint kernel
(``csrc/keypoints.cu``); this function is the plain version that the
CPU path and the kernel's checks use.
"""

import torch

from active_orb_slam2_tpu_torch.ops.fast import bf16_round

PATCH = 40      # raw patch side: 31 (BRIEF/IC) + 2*3 (blur halo) -> 40
PATCH_OFFSET = 18   # patch covers offsets [-18, +21] around the keypoint


def patch_index(v, n: int, pad: int):
    """[K, 40] clamped indices along one axis of length ``n`` of the
    patches around coordinates ``v`` [K]."""
    v0 = torch.clamp(v.long() + (pad - PATCH_OFFSET), 0,
                     n + 2 * pad - PATCH) - pad
    return torch.clamp(v0[:, None] + torch.arange(PATCH, device=v.device),
                       0, n - 1)


def extract_patches(level, ys, xs, pad: int):
    """[K, 40, 40] bf16-rounded patches around (ys, xs).

    ``level`` [h, w] float32 is the unpadded level image; ys/xs [K] int
    are keypoints in its coordinates; the patch window is clipped to the
    level padded by ``pad`` replicated pixels on each side.
    """
    h, w = level.shape
    rows = patch_index(ys, h, pad)[:, :, None]
    cols = patch_index(xs, w, pad)[:, None, :]
    return bf16_round(level)[rows, cols]
