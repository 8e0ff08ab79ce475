"""Wrapper of the fused motion-only BA kernel (``csrc/pose_opt.cu``).

The kernel replaces the Pallas kernel of
``active_orb_slam2_tpu/ops/pose_opt_kernel.py`` (``_build_kernel``).
Its plain version is ``ops/pose_opt_kernel.py::pose_optimization_fused_torch``.
"""

import torch

from active_orb_slam2_tpu_torch.kernels import build

# one block of 256 threads per problem, up to 8 edges each
# (csrc/pose_opt.cu)
MAX_EDGES = 2048


def pose_opt_cuda(cam, pose0, pw, obs_uvr, level, has_stereo, valid, w_table,
                  rounds: int, iters: int):
    """Run whole optimizations on the card, one launch for all problems:
    pose0 [7], pw / obs_uvr [E, 3] float32, level [E] int32, has_stereo /
    valid [E] bool for one problem (the tracking step's tensors as they
    are), or the same with a leading axis of P problems (pose0 [P, 7],
    pw [P, E, 3], ...); ``w_table`` [n] float32 is the information weight
    of levels 0..n-1 (levels beyond are clamped).

    Returns (out [(P,) 8]: pose and inlier chi2, n_inliers int32 [(P)],
    inliers bool [(P,) E]).
    """
    batch = pose0.shape[:-1]
    if len(batch) > 1:
        raise ValueError(f"pose_opt_cuda: pose0 {tuple(pose0.shape)}, "
                         f"expected [7] or [P, 7]")
    P = batch[0] if batch else 1
    E = pw.shape[-2] if pw.dim() >= 2 else 0
    build.require(pose0, "pose0", torch.float32, (*batch, 7))
    build.require(pw, "pw", torch.float32, (*batch, E, 3))
    build.require(obs_uvr, "obs_uvr", torch.float32, (*batch, E, 3))
    build.require(level, "level", torch.int32, (*batch, E))
    build.require(has_stereo, "has_stereo", torch.bool, (*batch, E))
    build.require(valid, "valid", torch.bool, (*batch, E))
    build.require(w_table, "w_table", torch.float32)
    for t in (pw, obs_uvr, level, has_stereo, valid, w_table):
        if t.device != pose0.device:
            raise ValueError("pose_opt_cuda: tensors on different devices")
    if not 1 <= E <= MAX_EDGES:
        raise ValueError(f"pose_opt_cuda: {E} edges, expected 1..{MAX_EDGES}")
    if w_table.dim() != 1 or w_table.numel() == 0:
        raise ValueError("pose_opt_cuda: w_table must be a nonempty vector")
    if rounds < 1 or iters < 1:
        raise ValueError("pose_opt_cuda: rounds and iters must be >= 1")
    dev = pose0.device
    out = torch.empty((*batch, 8), dtype=torch.float32, device=dev)
    n_inliers = torch.empty(batch, dtype=torch.int32, device=dev)
    inliers = torch.empty((*batch, E), dtype=torch.bool, device=dev)
    err = build.library().aos2_pose_opt(
        pose0.data_ptr(), pw.data_ptr(), obs_uvr.data_ptr(), level.data_ptr(),
        has_stereo.data_ptr(), valid.data_ptr(), w_table.data_ptr(),
        w_table.numel(), P, E, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
        rounds, iters, out.data_ptr(), n_inliers.data_ptr(),
        inliers.data_ptr(), build.stream_ptr(dev))
    build.check(err, "aos2_pose_opt")
    pose_opt_cuda.launches += 1
    return out, n_inliers, inliers


pose_opt_cuda.launches = 0
