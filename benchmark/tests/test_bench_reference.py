"""The plain reference against the program's plain paths on the CPU, the
committed vocabulary read back, and the trajectory arithmetic.

The frozen frame pipeline must be the program's function: on the CPU
the program runs the keypoint stage's plain version, so the two agree
bit for bit there, and the card's check then measures only what the
card's kernels and roundings change.
"""

import os

import numpy as np
import pytest
import torch

from benchmark.harness import check, definitions
from benchmark.reference import frame_ref, pose_ref, settings
from benchmark.reference import trajectory as T
from benchmark.traffic import world as W

HERE = os.path.dirname(os.path.abspath(__file__))
VOCAB = os.path.join(os.path.dirname(HERE), "data", "orb_vocab_k10_l4.txt")


def _cfgs(sensor, factor, n_features=512, n_levels=4):
    from benchmark.harness import session
    name = "kitti04_12_stereo" if sensor == "stereo" else "tum_fr1_rgbd"
    cj, path = definitions.config(name)
    cfg = session.port_config(cj, path, dict(
        factor=factor, n_features=n_features, n_levels=n_levels,
        max_keyframes=8, max_points=1024))
    rcam, rorb, _ = session.reference_config(cj, path, cfg)
    return cfg, rcam, rorb


def _frames(sensor, cam, n=2):
    mix = definitions.mix("revisit_laps" if sensor == "stereo"
                          else "explore_loop")
    mix["render"]["supersample"] = 1
    from benchmark.traffic import generate
    return generate.make(mix, cam, 10.0, sensor, 4242, n, torch.device("cpu"))


@pytest.mark.parametrize("sensor,factor", [("rgbd", 0.25), ("stereo", 0.3)])
def test_frozen_frame_pipeline_is_the_programs(sensor, factor):
    from active_orb_slam2_tpu_torch.models.frame import (
        build_frame_pipeline, build_stereo_pipeline)
    cfg, rcam, rorb = _cfgs(sensor, factor)
    tr = _frames(sensor, rcam)
    make = build_stereo_pipeline(cfg) if sensor == "stereo" \
        else build_frame_pipeline(cfg)[0]
    for i in range(2):
        a = torch.from_numpy(tr.images[0][i])
        b = torch.from_numpy(tr.images[1][i].astype(
            np.uint8 if sensor == "stereo" else np.int32))
        if sensor == "stereo":
            port, _ = make(a, b)
            ref = frame_ref.stereo_frame(rcam, rorb, a, b)
        else:
            port, _ = make(a, torch.from_numpy(tr.images[1][i]))
            ref = frame_ref.rgbd_frame(rcam, rorb, a, b)
        assert int(port.valid.sum()) > 100
        for k in ("uv", "level", "angle", "desc", "valid", "ur", "depth"):
            assert torch.equal(getattr(port, k), getattr(ref, k)), k
        d, t, bits, _ = check.frame_diff(check.host_frame(port),
                                         check.host_frame(ref))
        assert d == 0 and bits == 0 and t > 0


def test_bfloat16_frames_differ():
    cfg, rcam, rorb = _cfgs("rgbd", 0.25)
    tr = _frames("rgbd", rcam)
    a = torch.from_numpy(tr.images[0][0])
    b = torch.from_numpy(tr.images[1][0].astype(np.int32))
    f32 = check.host_frame(frame_ref.rgbd_frame(rcam, rorb, a, b))
    b16 = check.host_frame(frame_ref.rgbd_frame(rcam, rorb, a, b,
                                                torch.bfloat16))
    d, t, bits, nbits = check.frame_diff(b16, f32)
    assert d / t > 0.01 and bits / nbits > 0.001


def test_frozen_pose_solve_is_the_programs():
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.ops.pose_opt_kernel import (
        pose_optimization_fused_torch)
    g = torch.Generator().manual_seed(3)
    E = 200
    cam = CameraParams(517.3, 516.5, 318.6, 255.3, 40.0, 640, 480)
    pw = torch.rand(E, 3, generator=g) * torch.tensor([4.0, 3.0, 2.0]) \
        + torch.tensor([-2.0, -1.5, 2.0])
    uv = torch.stack([cam.fx * pw[:, 0] / pw[:, 2] + cam.cx,
                      cam.fy * pw[:, 1] / pw[:, 2] + cam.cy], -1)
    ur = uv[:, 0] - cam.bf / pw[:, 2]
    obs = torch.cat([uv, ur[:, None]], -1) + torch.randn(E, 3, generator=g)
    level = torch.randint(0, 8, (E,), generator=g, dtype=torch.int32)
    stereo = torch.rand(E, generator=g) < 0.7
    valid = torch.rand(E, generator=g) < 0.95
    pose0 = torch.tensor([0.999, 0.02, -0.03, 0.01, 0.05, -0.02, 0.03])
    pose0 = torch.cat([pose0[:4] / pose0[:4].norm(), pose0[4:]])
    want = pose_optimization_fused_torch(cam, pose0, pw, obs, level, stereo,
                                         valid)
    out, n_in, inl = pose_ref.solve(cam, pose0, pw, obs, level, stereo,
                                    valid, None, 4, 10, torch.float32)
    assert torch.allclose(out[:7], want.pose, atol=1e-5)
    assert torch.equal(inl, want.inliers) and int(n_in) == int(want.n_inliers)
    low, _, _ = pose_ref.solve(cam, pose0, pw, obs, level, stereo, valid,
                               None, 4, 10, torch.bfloat16)
    assert float((low[4:7] - want.pose[4:7]).abs().max()) > 1e-4


def test_vocabulary_reads_back_word_for_word(tmp_path):
    from active_orb_slam2_tpu_torch.models.vocabulary import (
        load_text_vocabulary, save_text_vocabulary)
    voc = load_text_vocabulary(VOCAB)
    assert (voc.k, voc.depth, voc.n_words) == (10, 4, 10_000)
    out = tmp_path / "again.txt"
    save_text_vocabulary(voc, str(out))
    with open(VOCAB) as a, open(out) as b:
        assert a.read() == b.read()


def test_settings_files_hold_the_published_numbers():
    cam, orb, fps = settings.load(
        definitions.config("tum_fr1_rgbd")[1], 640, 480)
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (517.306408, 516.469215,
                                                318.643040, 255.313989)
    assert cam.dist == (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    assert (cam.bf, fps, orb.n_features) == (40.0, 30.0, 1000)
    cam, orb, fps = settings.load(
        definitions.config("kitti04_12_stereo")[1], 1226, 370)
    assert (cam.fx, cam.cx, cam.cy, cam.bf) == (707.0912, 601.8873, 183.1104,
                                                379.8145)
    assert (fps, orb.n_features, orb.n_levels) == (10.0, 2000, 8)


def test_trajectory_arithmetic():
    from active_orb_slam2_tpu_torch.geometry.horn import umeyama_alignment
    rng = np.random.default_rng(0)
    twc = W.loop_poses(np.arange(0, 400, 7), 400, 2.5).astype(np.float64)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.linalg.det(R)
    A = np.eye(4)
    A[:3, :3], A[:3, 3] = R, [1.0, -2.0, 0.5]
    moved = A @ twc
    src = moved[:, :3, 3] + rng.normal(scale=0.01, size=(len(twc), 3))
    assert np.isclose(T.umeyama(src, twc[:, :3, 3])[2],
                      umeyama_alignment(src, twc[:, :3, 3],
                                        fix_scale=True)[4])
    # RPE does not see a global transform, and sees a scale drift
    assert T.rpe_translation(moved, twc, 5) < 1e-9
    drift = twc.copy()
    drift[:, :3, 3] *= 1.01
    assert T.rpe_translation(drift, twc, 5) > 1e-3
    # camera centres of Tcw quaternion poses, as the program computes them
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    p = rng.normal(size=(20, 7))
    p[:, :4] /= np.linalg.norm(p[:, :4], axis=1, keepdims=True)
    m = T.tcw_to_twc(p)
    assert np.allclose(m[:, :3, 3], camera_centers(p), atol=1e-12)
    assert np.allclose(m[:, :3, :3] @ m[:, :3, :3].transpose(0, 2, 1),
                       np.eye(3), atol=1e-12)
    lo, hi = np.array([-4.0, -3, -4]), np.array([4.0, 3, 4])
    pts = np.array([[3.9, 0, 0], [0, 0, 0], [4.2, 0, 0], [0, 2.5, -3.5]])
    box = np.array([[[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]]])
    assert np.allclose(T.surface_distance(pts, lo, hi, box),
                       [0.1, 0.5, 0.2, 0.5])
