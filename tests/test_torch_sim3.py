"""The port's Sim3 machinery against the JAX package's, on the CPU: the
Sim3 and SE3 logs and exps, Horn's alignment, the Sim3 RANSAC (with the
JAX package's Gumbel noise), ``optimize_sim3``, the essential graph's
edges and its optimization, plus ``tests/test_sim3_posegraph.py``'s
cases on the port.

Horn's 4x4 ``eigh`` is float32 in both packages, each from its own
LAPACK build; the RANSAC hypotheses here sit far from ties, so the
winners, masks and counts agree (measured spread of the Sim3 below
2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.geometry import horn as jhorn
from active_orb_slam2_tpu.geometry import se3 as jse3
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.models import pose_graph as jpg
from active_orb_slam2_tpu.models import sim3_solver as jsim
from active_orb_slam2_tpu_torch.geometry import horn as thorn
from active_orb_slam2_tpu_torch.geometry import se3 as tse3
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams as TCam
from active_orb_slam2_tpu_torch.models import pose_graph as tpg
from active_orb_slam2_tpu_torch.models import sim3_solver as tsim

torch.set_num_threads(1)

VGA = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640,
           height=480)
JC, TC = JCam(**VGA), TCam(**VGA)


def t(a):
    return torch.from_numpy(np.array(a))


def tangents(rng, n=64):
    """Sim3 tangents with angles near 0 and near pi, and tiny scales."""
    d = rng.normal(0.0, 0.5, (n, 7)).astype(np.float32)
    d[:8, :3] *= 1e-5                       # theta ~ 0
    d[8:12, :3] = 0.0
    d[12:20, 6] *= 1e-7                     # sigma ~ 0
    ax = rng.normal(size=(8, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    d[20:28, :3] = (ax * (np.pi - 10.0 ** -rng.uniform(1, 3, (8, 1))))
    return d


def test_sim3_se3_logs_exps_match_jax(rng):
    d = tangents(rng)
    je = np.asarray(jse3.sim3_exp(jnp.asarray(d)))
    te = tse3.sim3_exp(t(d)).numpy()
    np.testing.assert_allclose(te, je, atol=1e-6)
    np.testing.assert_allclose(tse3.sim3_log(t(je)).numpy(),
                               np.asarray(jse3.sim3_log(jnp.asarray(je))),
                               atol=1e-6 * max(1.0, float(np.abs(d).max())))
    p = np.asarray(jse3.se3_exp(jnp.asarray(d[:, :6])))
    np.testing.assert_allclose(tse3.se3_log(t(p)).numpy(),
                               np.asarray(jse3.se3_log(jnp.asarray(p))),
                               atol=2e-6)
    for a, b in ((je[:32], je[32:]), (je[5:37], je[20:52])):
        np.testing.assert_allclose(
            tse3.sim3_compose(t(a), t(b)).numpy(),
            np.asarray(jse3.sim3_compose(jnp.asarray(a), jnp.asarray(b))),
            atol=1e-6)
    np.testing.assert_allclose(tse3.sim3_inverse(t(je)).numpy(),
                               np.asarray(jse3.sim3_inverse(jnp.asarray(je))),
                               atol=1e-5)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.sim3_apply(t(je), t(x)).numpy(),
        np.asarray(jse3.sim3_apply(jnp.asarray(je), jnp.asarray(x))),
        atol=2e-6)
    np.testing.assert_allclose(tse3.sim3_to_se3(t(je)).numpy(),
                               np.asarray(jse3.sim3_to_se3(jnp.asarray(je))),
                               atol=1e-6)
    m44 = np.asarray(jse3.se3_to_mat44(jnp.asarray(p)))
    np.testing.assert_allclose(tse3.mat44_to_se3(t(m44)).numpy(),
                               np.asarray(jse3.mat44_to_se3(jnp.asarray(m44))),
                               atol=1e-6)
    np.testing.assert_array_equal(tse3.sim3_identity((2,)).numpy(),
                                  np.asarray(jse3.sim3_identity((2,))))


def test_sim3_jacobian_matches_jax(rng):
    """The residual Jacobian the solvers take by forward mode, at a
    generic Sim3 and at the identity residual (small-angle branches)."""
    g = np.asarray(jse3.sim3_exp(jnp.asarray(tangents(rng)[30])))
    for base in (g, np.asarray(jse3.sim3_identity())):
        jj = np.asarray(jax.jacfwd(lambda d: jse3.sim3_log(jse3.sim3_compose(
            jse3.sim3_exp(d), jnp.asarray(base))))(jnp.zeros(7)))
        tj = torch.func.jacfwd(lambda d: tse3.sim3_log(tse3.sim3_compose(
            tse3.sim3_exp(d), t(base))))(torch.zeros(7))
        assert tj.dtype == torch.float32
        np.testing.assert_allclose(tj.numpy(), jj, atol=1e-5)


def test_horn_align_matches_jax(rng):
    src = rng.normal(size=(16, 20, 3)).astype(np.float32)
    g = np.asarray(jse3.sim3_exp(jnp.asarray(tangents(rng)[::4])))
    dst = np.asarray(jse3.sim3_apply(jnp.asarray(g)[:, None],
                                     jnp.asarray(src)))
    dst = dst + rng.normal(0, 0.01, dst.shape).astype(np.float32)
    w = (rng.random((16, 20)) < 0.8).astype(np.float32)
    for fix in (False, True):
        jr = jhorn.horn_align(jnp.asarray(src), jnp.asarray(dst),
                              weights=jnp.asarray(w), fix_scale=fix)
        tr = thorn.horn_align(t(src), t(dst), weights=t(w), fix_scale=fix)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _project_np(pc):
    return np.stack([525.0 * pc[:, 0] / pc[:, 2] + 319.5,
                     525.0 * pc[:, 1] / pc[:, 2] + 239.5], axis=-1)


def ransac_problem(rng, M=120, fix_scale=False, bad_share=0.3):
    xyz_b = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (M, 3)).astype(np.float32)
    tw = np.array([0.05, -0.1, 0.08, 0.4, -0.2, 0.3,
                   0.0 if fix_scale else 0.15], np.float32)
    g = jse3.sim3_exp(jnp.asarray(tw))
    xyz_a = np.asarray(jse3.sim3_apply(g, jnp.asarray(xyz_b)))
    bad = rng.random(M) < bad_share
    noisy_b = xyz_b.copy()
    noisy_b[bad] = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (bad.sum(), 3))
    uv_a = _project_np(xyz_a) + rng.normal(0, 0.3, (M, 2))
    uv_b = _project_np(noisy_b) + rng.normal(0, 0.3, (M, 2))
    s2a = 1.2 ** (2.0 * rng.integers(0, 4, M))
    s2b = 1.2 ** (2.0 * rng.integers(0, 4, M))
    valid = rng.random(M) < 0.9
    return [a.astype(np.float32) for a in
            (xyz_a, noisy_b, uv_a, uv_b, s2a, s2b)] + [valid]


@pytest.mark.parametrize("seed,fix_scale", [(0, False), (1, True), (2, False),
                                            (3, True)])
def test_sim3_ransac_and_optimize_match_jax(seed, fix_scale):
    rng = np.random.default_rng(seed)
    args = ransac_problem(rng, fix_scale=fix_scale)
    key = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.gumbel(key, (tsim.N_HYPOTHESES,
                                               len(args[0]))))
    jr = jsim.sim3_ransac(key, JC, *map(jnp.asarray, args),
                          fix_scale=fix_scale)
    tr = tsim.sim3_ransac(t(noise), TC, *map(t, args), fix_scale=fix_scale)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers)
    assert bool(tr.ok) == bool(jr.ok) is True
    np.testing.assert_allclose(tr.sim3_ab.numpy(), np.asarray(jr.sim3_ab),
                               atol=1e-4)
    # OptimizeSim3 from the same start
    s0 = np.asarray(jr.sim3_ab)
    valid = args[6] & np.asarray(jr.inliers)
    js, ji, jn = jsim.optimize_sim3(JC, jnp.asarray(s0),
                                    *map(jnp.asarray, args[:6]),
                                    jnp.asarray(valid), fix_scale=fix_scale)
    ts, ti, tn = tsim.optimize_sim3(TC, t(s0), *map(t, args[:6]), t(valid),
                                    fix_scale=fix_scale)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn)


def _random_graph(rng, K=10):
    tw = rng.normal(0, 0.3, (K, 7)).astype(np.float32)
    tw[:, 6] *= 0.1
    S = np.asarray(jse3.sim3_exp(jnp.asarray(tw)))
    valid = np.ones(K, bool)
    valid[7] = False
    parent = np.concatenate([[-1], np.arange(K - 1)]).astype(np.int32)
    parent[4] = 7                                  # an invalid parent
    W = rng.integers(0, 250, (K, K)).astype(np.int32)
    W = np.triu(W, 1) + np.triu(W, 1).T
    W[2, 5] = W[5, 2] = W[1, 6] = W[6, 1] = 150    # a tie at the top
    li = np.array([1, 3, -1, -1], np.int32)
    lj = np.array([8, 9, -1, -1], np.int32)
    return S, valid, parent, W, li, lj


def test_build_essential_edges_matches_jax(rng):
    S, valid, parent, W, li, lj = _random_graph(rng)
    je = jpg.build_essential_edges(jnp.asarray(S), jnp.asarray(valid),
                                   jnp.asarray(parent), jnp.asarray(W),
                                   jnp.asarray(li), jnp.asarray(lj),
                                   max_strong=16, max_loop=4)
    te = tpg.build_essential_edges(t(S), t(valid), t(parent), t(W), t(li),
                                   t(lj), max_strong=16, max_loop=4)
    for f in ("i", "j", "valid"):
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)), f)
    np.testing.assert_allclose(te.meas_ji.numpy(), np.asarray(je.meas_ji),
                               atol=1e-6)
    np.testing.assert_array_equal(te.weight.numpy(), np.asarray(je.weight))


def test_optimize_essential_graph_matches_jax(rng):
    S, valid, parent, W, li, lj = _random_graph(rng)
    je = jpg.build_essential_edges(jnp.asarray(S), jnp.asarray(valid),
                                   jnp.asarray(parent), jnp.asarray(W),
                                   jnp.asarray(li), jnp.asarray(lj),
                                   max_strong=16, max_loop=4)
    # vertices moved off the measurements, the loop edges' measurements
    # moved too, so the graph has work to do
    d = rng.normal(0, 0.05, (len(S), 7)).astype(np.float32)
    S0 = np.asarray(jse3.sim3_compose(jse3.sim3_exp(jnp.asarray(d)),
                                      jnp.asarray(S)))
    meas = np.asarray(je.meas_ji).copy()
    meas[-4:-2] = np.asarray(jse3.sim3_compose(
        jse3.sim3_exp(jnp.asarray(d[:2] * 2)), jnp.asarray(meas[-4:-2])))
    je = je._replace(meas_ji=jnp.asarray(meas))
    te = tpg.Sim3Edges(*[t(np.asarray(a)) for a in je])
    fixed = ~valid
    fixed[0] = True
    jS, jchi = jpg.optimize_essential_graph(jnp.asarray(S0), je,
                                            jnp.asarray(fixed))
    tS, tchi = tpg.optimize_essential_graph(t(S0), te, t(fixed))
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), atol=1e-4)
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-3, atol=1e-6)
    assert float(tchi) < float(jpg.optimize_essential_graph(
        jnp.asarray(S0), je, jnp.asarray(fixed), iters=0)[1] + 1e9)


# ------------------------------- tests/test_sim3_posegraph.py on the port

def test_sim3_ransac_recovers(rng):
    M = 80
    xyz_b = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (M, 3)).astype(np.float32)
    g = tse3.sim3_exp(torch.tensor([0.05, -0.1, 0.08, 0.4, -0.2, 0.3, 0.15]))
    xyz_a = tse3.sim3_apply(g, t(xyz_b)).numpy()
    bad = rng.random(M) < 0.25
    noisy = xyz_b.copy()
    noisy[bad] = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (bad.sum(), 3))
    gen = torch.Generator().manual_seed(0)
    res = tsim.sim3_ransac(
        tsim.gumbel_noise(tsim.N_HYPOTHESES, M, gen, "cpu"), TC, t(xyz_a),
        t(noisy), t(_project_np(xyz_a)).float(), t(_project_np(noisy)).float(),
        torch.ones(M), torch.ones(M), torch.ones(M, dtype=torch.bool))
    assert bool(res.ok)
    inl = res.inliers.numpy()
    assert inl[bad].sum() <= 2 and inl[~bad].mean() > 0.9
    err = tse3.sim3_log(tse3.sim3_compose(res.sim3_ab, tse3.sim3_inverse(g)))
    assert float(err.norm()) < 1e-2


def test_sim3_ransac_fix_scale(rng):
    M = 40
    xyz_b = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (M, 3)).astype(np.float32)
    g = tse3.sim3_exp(torch.tensor([0.0, 0.0, 0.1, 0.3, 0.1, 0.0, 0.0]))
    xyz_a = tse3.sim3_apply(g, t(xyz_b)).numpy()
    gen = torch.Generator().manual_seed(1)
    res = tsim.sim3_ransac(
        tsim.gumbel_noise(tsim.N_HYPOTHESES, M, gen, "cpu"), TC, t(xyz_a),
        t(xyz_b), t(_project_np(xyz_a)).float(), t(_project_np(xyz_b)).float(),
        torch.ones(M), torch.ones(M), torch.ones(M, dtype=torch.bool),
        fix_scale=True)
    assert bool(res.ok)
    assert abs(float(res.sim3_ab[7]) - 1.0) < 1e-6


def test_pose_graph_closes_loop():
    """A chain of 8 Sim3s with drift and one true loop edge: the
    optimization spreads the error."""
    K = 8
    inc_true = tse3.sim3_exp(torch.tensor([0, 0, 2 * np.pi / K, 0.8, 0, 0, 0]))
    drift = tse3.sim3_exp(torch.tensor([0, 0, 0.03, 0.05, 0, 0, 0.01]))
    S_true, S_est = [tse3.sim3_identity()], [tse3.sim3_identity()]
    for _ in range(K - 1):
        S_true.append(tse3.sim3_compose(inc_true, S_true[-1]))
        S_est.append(tse3.sim3_compose(tse3.sim3_compose(drift, inc_true),
                                       S_est[-1]))
    S_true, S_est = torch.stack(S_true), torch.stack(S_est)
    ii = torch.arange(K - 1)
    chain = tse3.sim3_compose(S_est[1:], tse3.sim3_inverse(S_est[:-1]))
    loop = tse3.sim3_compose(S_true[K - 1], tse3.sim3_inverse(S_true[0]))
    edges = tpg.Sim3Edges(
        i=torch.cat([ii, torch.tensor([0])]),
        j=torch.cat([ii + 1, torch.tensor([K - 1])]),
        meas_ji=torch.cat([chain, loop[None]]),
        valid=torch.ones(K, dtype=torch.bool),
        weight=torch.cat([torch.ones(K - 1), torch.tensor([5.0])]))
    fixed = torch.arange(K) == 0
    S_opt, _ = tpg.optimize_essential_graph(S_est, edges, fixed, iters=30)

    def loop_err(S):
        return float(tse3.sim3_log(tse3.sim3_compose(
            tse3.sim3_inverse(loop), tse3.sim3_compose(
                S[K - 1], tse3.sim3_inverse(S[0])))).norm())

    def end_err(S):
        return float(tse3.sim3_log(tse3.sim3_compose(
            S[K - 1], tse3.sim3_inverse(S_true[K - 1]))).norm())
    assert loop_err(S_opt) < 0.15 * loop_err(S_est)
    assert end_err(S_opt) < 0.5 * end_err(S_est)


def test_build_essential_edges_counts():
    K = 6
    W = torch.zeros((K, K), dtype=torch.int32)
    W[0, 5] = W[5, 0] = 150
    e = tpg.build_essential_edges(
        tse3.sim3_identity((K,)), torch.ones(K, dtype=torch.bool),
        torch.tensor([-1, 0, 1, 2, 3, 4], dtype=torch.int32), W,
        torch.tensor([2, -1]), torch.tensor([4, -1]), max_strong=4)
    assert int(e.valid.sum()) == 7      # 5 tree + 1 covisibility + 1 loop


def test_optimize_sim3_beats_horn_under_depth_noise(rng):
    """LM over projection residuals beats the 3D Horn fit when the points
    carry depth noise and the pixels are clean."""
    cam = TCam(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8, width=320,
               height=240)
    M = 200
    th = 0.3
    s_true = torch.tensor([np.cos(th / 2), 0.0, np.sin(th / 2), 0.0,
                           0.4, -0.1, 0.2, 1.07], dtype=torch.float32)
    pts_b = t(rng.uniform([-1.5, -1, 3], [1.5, 1, 8], (M, 3)).astype(
        np.float32))
    pts_a = tse3.sim3_apply(s_true, pts_b)

    def project(p):
        return torch.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                            cam.fy * p[:, 1] / p[:, 2] + cam.cy], -1)
    za = t(1.0 + 0.05 * rng.standard_normal(M).astype(np.float32))
    zb = t(1.0 + 0.05 * rng.standard_normal(M).astype(np.float32))
    noisy_a, noisy_b = pts_a * za[:, None], pts_b * zb[:, None]
    valid = torch.ones(M, dtype=torch.bool)
    q, tt, s = thorn.horn_align(noisy_b, noisy_a, weights=valid.float())
    s_horn = torch.cat([q, tt, s[None]])
    s_opt, _, n = tsim.optimize_sim3(cam, s_horn, noisy_a, noisy_b,
                                     project(pts_a), project(pts_b),
                                     torch.ones(M), torch.ones(M), valid)

    def err(x):
        return float(tse3.sim3_log(tse3.sim3_compose(
            x, tse3.sim3_inverse(s_true))).norm())
    assert int(n) > 100
    assert err(s_opt) < 0.5 * err(s_horn) and err(s_opt) < 0.02
