"""Wrapper of the keypoint kernel (``csrc/keypoints.cu``).

The kernel replaces the Pallas patch gather of
``active_orb_slam2_tpu/ops/patches.py`` (``_window_call``) and fuses
everything ``ops/orb.py::_keypoint_stage`` does with the patch.  Its
plain version is ``ops/orb.py::keypoint_stage_torch``.
"""

import torch

from active_orb_slam2_tpu_torch.kernels import build


def keypoint_stage_cuda(img_padded, ys, xs, pad: int, taps, gauss):
    """(angles [K] float32, desc [K, 8] int32) for keypoints (ys, xs) of
    one padded level image, all on the card."""
    hp, wp = img_padded.shape
    K = ys.shape[0]
    build.require(img_padded, "img_padded", torch.float32)
    build.require(ys, "ys", torch.int32, (K,))
    build.require(xs, "xs", torch.int32, (K,))
    build.require(taps, "taps", torch.int32, (30, 512))
    build.require(gauss, "gauss", torch.float32, (7,))
    for t in (ys, xs, taps, gauss):
        if t.device != img_padded.device:
            raise ValueError("keypoint_stage_cuda: tensors on different devices")
    if hp < 40 or wp < 40:
        raise ValueError(f"padded level {hp}x{wp} smaller than a 40x40 patch")
    angle = torch.empty(K, dtype=torch.float32, device=img_padded.device)
    desc = torch.empty((K, 8), dtype=torch.int32, device=img_padded.device)
    if K == 0:
        return angle, desc
    err = build.library().aos2_keypoints(
        img_padded.data_ptr(), hp, wp, ys.data_ptr(), xs.data_ptr(), K, pad,
        taps.data_ptr(), gauss.data_ptr(), angle.data_ptr(), desc.data_ptr(),
        build.stream_ptr(img_padded.device))
    build.check(err, "aos2_keypoints")
    keypoint_stage_cuda.launches += 1
    return angle, desc


keypoint_stage_cuda.launches = 0
