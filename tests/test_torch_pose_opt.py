"""The port's motion-only BA against the JAX package, on the CPU.

The plain version of the fused kernel (``pose_optimization_fused_torch``,
what a CPU tensor runs) is held to the JAX Pallas kernel run in
interpret mode, and to the JAX reference ``pose_optimization`` at the
bar ``tests/test_optimizer.py`` holds the Pallas kernel to.  The port's
own ``pose_optimization`` is held to the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.geometry import CameraParams as JCam
from active_orb_slam2_tpu.geometry import se3 as jse3
from active_orb_slam2_tpu.models import optimizer as jopt
from active_orb_slam2_tpu.ops import pose_opt_kernel as jkern
from active_orb_slam2_tpu_torch.geometry import CameraParams as TCam
from active_orb_slam2_tpu_torch.geometry import se3 as tse3
from active_orb_slam2_tpu_torch.models import optimizer as topt
from active_orb_slam2_tpu_torch.ops import pose_opt_kernel as tkern

torch.set_num_threads(1)

CAM = dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=30.0, width=320,
           height=240)


def noisy_problem(seed, E=256):
    """The problem of test_optimizer.py::test_fused_pose_opt_matches_
    reference_impl: noisy stereo/mono edges, 10% outliers, levels 0-3."""
    rng = np.random.default_rng(seed)
    pw = rng.uniform(-2, 2, (E, 3)).astype(np.float32)
    pw[:, 2] += 5.0
    true_pose = np.array([0.9990482, 0.0, 0.0436194, 0.0, 0.1, -0.05, 0.2],
                         np.float32)
    pc = np.asarray(jse3.se3_apply(true_pose, pw))
    u = CAM["fx"] * pc[:, 0] / pc[:, 2] + CAM["cx"]
    v = CAM["fy"] * pc[:, 1] / pc[:, 2] + CAM["cy"]
    obs = np.stack([u, v, u - CAM["bf"] / pc[:, 2]], -1)
    obs = obs + rng.normal(0, 0.5, (E, 3))
    out = rng.random(E) < 0.1
    obs = np.where(out[:, None], obs + rng.uniform(20, 80, (E, 3)), obs)
    level = rng.integers(0, 4, E).astype(np.int32)
    stereo = rng.random(E) < 0.5
    valid = np.ones(E, bool)
    pose0 = np.array([1.0, 0, 0, 0, 0.05, 0.0, 0.15], np.float32)
    return (pose0, pw, obs.astype(np.float32), level, stereo, valid), \
        true_pose


def scene_problem(seed, mono=False, outliers=0):
    """The scenes of test_optimizer.py's convergence / outlier / mono
    cases: 200 points, a perturbed start."""
    rng = np.random.default_rng(seed)
    cam = JCam(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640,
               height=480)
    pw = rng.uniform([-2, -1.5, 2], [2, 1.5, 8], (200, 3)).astype(np.float32)
    T_true = np.asarray(jse3.se3_exp(jnp.array(
        [0.03, -0.05, 0.02, 0.1, -0.2, 0.15])))
    pc = np.asarray(jse3.se3_apply(T_true, pw))
    uvr = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                    cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    uvr = np.concatenate([uvr, uvr[:, :1] - cam.bf / pc[:, 2:3]], -1)
    if outliers:
        uvr[:outliers] += rng.uniform(30, 80, (outliers, 3))
    T0 = np.asarray(jse3.se3_compose(
        jse3.se3_exp(jnp.array([0.01, 0.0, -0.01, 0.05, 0.0, -0.05])),
        T_true))
    args = (T0, pw, uvr.astype(np.float32), np.zeros(200, np.int32),
            np.full(200, not mono), np.ones(200, bool))
    return cam, args, T_true


def run_torch(fn, cam_args, args):
    t = [torch.from_numpy(np.array(a)) for a in args]
    return fn(TCam(**cam_args), *t)


def pose_err(p, q):
    return float(np.linalg.norm(np.asarray(jse3.se3_log(jse3.se3_compose(
        jnp.asarray(p), jse3.se3_inverse(jnp.asarray(q)))))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_kernel_matches_jax_fused(seed):
    args, _ = noisy_problem(seed)
    ref = jkern.pose_optimization_fused(JCam(**CAM), *map(jnp.asarray, args))
    got = run_torch(tkern.pose_optimization_fused, CAM, args)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-4)
    agree = (got.inliers.numpy() == np.asarray(ref.inliers)).mean()
    assert agree >= 0.99, agree
    assert got.inliers.dtype == torch.bool and got.n_inliers.dtype == torch.int32


@pytest.mark.parametrize("E", [1, 2000])
def test_fused_entry_edge_counts_match_jax(E):
    """The K1 entry on the CPU at the fewest edges and at 2000, the
    feature count of ``bench.py``'s KITTI stereo window."""
    args, _ = noisy_problem(0, E)
    ref = jkern.pose_optimization_fused(JCam(**CAM), *map(jnp.asarray, args))
    got = run_torch(tkern.pose_optimization_fused, CAM, args)
    # one edge gives 3 residuals for 6 unknowns, so the damped steps
    # amplify float rounding: the two packages differ by up to 1.05e-3 in
    # the pose over seeds 0-2 there, and by at most 1.2e-5 at E >= 300
    atol = 2e-3 if E == 1 else 1e-4
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose),
                               atol=atol)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_kernel_matches_jax_reference(seed):
    args, true_pose = noisy_problem(seed)
    ref = jopt.pose_optimization(JCam(**CAM), *map(jnp.asarray, args))
    got = run_torch(tkern.pose_optimization_fused_torch, CAM, args)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose),
                               atol=2e-3)
    assert (got.inliers.numpy() == np.asarray(ref.inliers)).mean() > 0.97
    assert np.linalg.norm(got.pose.numpy()[4:7] - true_pose[4:7]) < 0.02


@pytest.mark.parametrize("seed", [0, 3])
def test_pose_optimization_matches_jax(seed):
    args, _ = noisy_problem(seed)
    ref = jopt.pose_optimization(JCam(**CAM), *map(jnp.asarray, args))
    got = run_torch(topt.pose_optimization, CAM, args)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-4)
    assert (got.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-3)


@pytest.mark.parametrize("fn", [topt.pose_optimization,
                                tkern.pose_optimization_fused])
@pytest.mark.parametrize("case", ["outliers", "mono"])
def test_scene_cases(fn, case):
    """test_optimizer.py's outlier-rejection and mono-only cases."""
    cam, args, T_true = scene_problem(0, mono=case == "mono",
                                      outliers=40 if case == "outliers" else 0)
    res = run_torch(fn, cam._asdict(), args)
    inl = res.inliers.numpy()
    if case == "outliers":
        assert inl[:40].sum() <= 3
        assert inl[40:].mean() > 0.95
        assert pose_err(res.pose.numpy(), T_true) < 5e-3
    else:
        assert pose_err(res.pose.numpy(), T_true) < 1e-3


def test_solve_spd_and_inv_sigma2_match_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = A @ A.T + 0.1 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(
        topt.solve_spd(torch.from_numpy(H), torch.from_numpy(b)).numpy(),
        np.asarray(jopt.solve_spd(jnp.asarray(H), jnp.asarray(b))),
        rtol=1e-4, atol=1e-5)
    lv = np.arange(8, dtype=np.int32)
    np.testing.assert_allclose(topt.inv_sigma2(torch.from_numpy(lv)).numpy(),
                               np.asarray(jopt.inv_sigma2(jnp.asarray(lv))),
                               rtol=1e-6)


def test_retract_matches_se3_retract():
    rng = np.random.default_rng(6)
    pose = tse3.se3_exp(torch.from_numpy(
        rng.normal(0, 0.3, 6).astype(np.float32)))
    for scale in (1e-8, 1e-3, 0.5):
        step = torch.from_numpy(rng.normal(0, scale, 6).astype(np.float32))
        np.testing.assert_allclose(tkern._retract(pose, step).numpy(),
                                   tse3.se3_retract(pose, step).numpy(),
                                   atol=1e-6)
