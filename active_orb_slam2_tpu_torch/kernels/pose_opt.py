"""Wrapper of the fused motion-only BA kernel (``csrc/pose_opt.cu``).

The kernel replaces the Pallas kernel of
``active_orb_slam2_tpu/ops/pose_opt_kernel.py`` (``_build_kernel``).
Its plain version is ``ops/pose_opt_kernel.py::pose_optimization_fused_torch``.
"""

import torch

from active_orb_slam2_tpu_torch.kernels import build


def pose_opt_cuda(cam, pose_in, pw_t, obs_t, aux, rounds: int, iters: int):
    """Run the whole optimization on the card.

    pose_in [8] (pose + unused), pw_t / obs_t [3, E], aux [4, E]
    (w_info, stereo flag, valid, chi2 threshold), all float32.
    Returns (out [8]: pose and inlier chi2, mask [E]: 1.0 for inliers).
    """
    E = pw_t.shape[1]
    build.require(pose_in, "pose_in", torch.float32, (8,))
    build.require(pw_t, "pw", torch.float32, (3, E))
    build.require(obs_t, "obs", torch.float32, (3, E))
    build.require(aux, "aux", torch.float32, (4, E))
    for t in (pw_t, obs_t, aux):
        if t.device != pose_in.device:
            raise ValueError("pose_opt_cuda: tensors on different devices")
    if E == 0:
        raise ValueError("pose_opt_cuda: no edges")
    out = torch.empty(8, dtype=torch.float32, device=pose_in.device)
    mask = torch.empty(E, dtype=torch.float32, device=pose_in.device)
    err = build.library().aos2_pose_opt(
        pose_in.data_ptr(), pw_t.data_ptr(), obs_t.data_ptr(), aux.data_ptr(),
        E, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, rounds, iters,
        out.data_ptr(), mask.data_ptr(), build.stream_ptr(pose_in.device))
    build.check(err, "aos2_pose_opt")
    pose_opt_cuda.launches += 1
    return out, mask


pose_opt_cuda.launches = 0
