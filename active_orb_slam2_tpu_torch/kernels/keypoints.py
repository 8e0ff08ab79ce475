"""Wrapper of the keypoint kernel (``csrc/keypoints.cu``).

The kernel replaces the Pallas patch gather of
``active_orb_slam2_tpu/ops/patches.py`` (``_window_call``) and fuses
everything ``ops/orb.py::_keypoint_stage`` does with the patch, for all
levels of a frame in one launch.  Its plain version is
``ops/orb.py::keypoint_stage_torch``.
"""

import ctypes

import torch

from active_orb_slam2_tpu_torch.kernels import build
from active_orb_slam2_tpu_torch.ops.patches import PATCH
from active_orb_slam2_tpu_torch.utils import trace

MAX_LEVELS = 16


def keypoint_stage_cuda(levels, ys, xs, counts, pad: int, taps, gauss):
    """(angles [K] float32, desc [K, 8] int32) for the keypoints of all
    levels, in one launch on the card.

    ``levels`` are the unpadded level images [h_l, w_l] float32;
    ys / xs [K] int32 hold level 0's ``counts[0]`` keypoints, then level
    1's, and so on, in unpadded level coordinates; ``pad`` is the
    replicate border the patch window is clipped to.
    """
    n = len(levels)
    K = ys.shape[0]
    if not 1 <= n <= MAX_LEVELS or len(counts) != n:
        raise ValueError(f"keypoint_stage_cuda: {n} levels and {len(counts)} "
                         f"counts, expected 1..{MAX_LEVELS} of each")
    if min(counts) < 0 or sum(counts) != K:
        raise ValueError(f"keypoint_stage_cuda: counts {list(counts)} do not "
                         f"split {K} keypoints")
    dev = ys.device
    build.require(ys, "ys", torch.int32, (K,))
    build.require(xs, "xs", torch.int32, (K,))
    build.require(taps, "taps", torch.int32, (30, 512))
    build.require(gauss, "gauss", torch.float32, (7,))
    for lvl, img in enumerate(levels):
        build.require(img, f"level {lvl}", torch.float32)
        if img.dim() != 2 or min(img.shape) + 2 * pad < PATCH:
            raise ValueError(f"level {lvl} {tuple(img.shape)} with pad {pad} "
                             f"is smaller than a {PATCH}x{PATCH} patch")
    for t in (xs, taps, gauss, *levels):
        if t.device != dev:
            raise ValueError("keypoint_stage_cuda: tensors on different devices")
    angle = torch.empty(K, dtype=torch.float32, device=dev)
    desc = torch.empty((K, 8), dtype=torch.int32, device=dev)
    if K == 0:
        return angle, desc
    starts = [sum(counts[:lvl]) for lvl in range(n)]
    err = build.library().aos2_keypoints(
        (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
        (ctypes.c_int * n)(*[img.shape[0] for img in levels]),
        (ctypes.c_int * n)(*[img.shape[1] for img in levels]),
        (ctypes.c_int * n)(*starts), n, ys.data_ptr(), xs.data_ptr(), K, pad,
        taps.data_ptr(), gauss.data_ptr(), angle.data_ptr(), desc.data_ptr(),
        build.stream_ptr(dev))
    build.check(err, "aos2_keypoints")
    trace.count("k2.launches")
    return angle, desc
