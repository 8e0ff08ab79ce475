"""Keypoint patch gather: the plain PyTorch version of what the Pallas
kernel of ``active_orb_slam2_tpu/ops/patches.py`` computes.

The TPU kernel DMAs a tile-aligned 56-row window around each keypoint
and cuts the 40x40 patch out of it with two bf16 one-hot matmuls.  Its
net function is a slice of the bf16-rounded level image:

  patch[k] = bf16(img)[y0:y0+40, x0:x0+40],
  y0 = clip(y + pad - 18, 0, Hp - 40), and likewise for x.

On the card this gather is fused into the keypoint kernel
(``csrc/keypoints.cu``); this function is the plain version that the
CPU path and the kernel's checks use.
"""

import torch

from active_orb_slam2_tpu_torch.ops.fast import bf16_round

PATCH = 40      # raw patch side: 31 (BRIEF/IC) + 2*3 (blur halo) -> 40
PATCH_OFFSET = 18   # patch covers offsets [-18, +21] around the keypoint


def extract_patches(img_padded, ys, xs, pad: int):
    """[K, 40, 40] bf16-rounded patches around (ys, xs).

    ``img_padded`` [Hp, Wp] float32 is the level image with ``pad``
    pixels of border; ys/xs [K] int are keypoints in unpadded
    coordinates.
    """
    hp, wp = img_padded.shape
    y0 = torch.clamp(ys.long() + (pad - PATCH_OFFSET), 0, hp - PATCH)
    x0 = torch.clamp(xs.long() + (pad - PATCH_OFFSET), 0, wp - PATCH)
    ar = torch.arange(PATCH, device=img_padded.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return bf16_round(img_padded)[rows, cols]
