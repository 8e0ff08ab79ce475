"""Image primitives: bilinear resize, separable Gaussian blur, padding.

Port of ``active_orb_slam2_tpu/ops/image.py``.  The keypoint stage
fuses its blur and padding into K2 and K2's plain version
(``kernels/keypoints.py``); ``gaussian_blur`` and ``pad_image`` are the
JAX module's standalone functions, as plain tensor operations.  The
resize keeps the JAX package's banded weight matrices and runs them as
two float32 matrix products, so level images carry the same fractional
values (they are rounded to bf16 later, which makes the exact values
matter).  TF32 stays off for those products: PyTorch's default on the
card.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(ksize: int, sigma: float):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def pad_image(img, pad: int):
    """Edge-replicate pad of [H, W] on both axes."""
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur of [H, W] float32 (edge-replicate
    padding), the JAX function's shift-and-accumulate in its order."""
    k = gaussian_kernel1d(ksize, sigma)
    h, w = img.shape
    x = pad_image(img, ksize // 2)
    acc = x[0:h, :] * float(k[0])
    for i in range(1, ksize):
        acc = acc + x[i:i + h, :] * float(k[i])
    out = acc[:, 0:w] * float(k[0])
    for i in range(1, ksize):
        out = out + acc[:, i:i + w] * float(k[i])
    return out


@functools.lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int):
    """Banded bilinear interpolation matrix [n_in, n_out] float32 with
    half-pixel centres and edge clamp."""
    scale = n_in / n_out
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(centers).astype(np.int64)
    frac = (centers - lo).astype(np.float32)
    w = np.zeros((n_in, n_out), np.float32)
    lo0 = np.clip(lo, 0, n_in - 1)
    lo1 = np.clip(lo + 1, 0, n_in - 1)
    w[lo0, np.arange(n_out)] += 1.0 - frac
    w[lo1, np.arange(n_out)] += frac
    return w


@functools.lru_cache(maxsize=None)
def _resize_weights_on(n_in: int, n_out: int, device: torch.device):
    # cached per device: a fresh host-to-device copy every frame would
    # make the host wait on the stream
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize_bilinear(img, out_h: int, out_w: int):
    """Bilinear resize of [H, W] float32 to [out_h, out_w]; the same
    size returns the image unchanged."""
    h, w = img.shape
    if (h, w) == (out_h, out_w):
        return img
    wy = _resize_weights_on(h, out_h, img.device)
    wx = _resize_weights_on(w, out_w, img.device)
    return (wy.T @ img) @ wx
