"""The port's single-device global BA against the JAX package's
``parallel/dist_ba.py``, on the CPU: the point-major edges from an
arena, the dropped-observation count, the anchor-block order, and
``global_ba`` by Schur PCG and by the dense Schur solve on
``tests/test_dist_ba.py``'s synthetic problem."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.config import MapConfig, OrbConfig
from active_orb_slam2_tpu.geometry import se3 as jse3
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.models.map_state import empty_map
from active_orb_slam2_tpu.parallel import dist_ba as jba
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams as TCam
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.parallel import dist_ba as tba
from tests.test_dist_ba import make_problem, perturb

torch.set_num_threads(1)

VGA = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640,
           height=480)
JC, TC = JCam(**VGA), TCam(**VGA)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def arena():
    """A random arena (8 keyframes, 48 features, 96 points) with holes:
    invalid keyframes and features, points seen by up to 7 keyframes,
    some by one feature twice."""
    rng = np.random.default_rng(4)
    m = empty_map(MapConfig(max_keyframes=8, max_points=96),
                  OrbConfig(n_features=48))
    kfp = rng.integers(-40, 96, (8, 48)).astype(np.int32)
    kfp[kfp < 0] = -1
    kfp[:, :6] = np.arange(6)                     # 8 observers each
    arrays = {f: np.asarray(v) for f, v in zip(m._fields, m)}
    arrays.update(
        kf_point=kfp, kf_valid=np.arange(8) != 5,
        kf_feat_valid=rng.random((8, 48)) < 0.9,
        kf_uv=rng.uniform(0, 600, (8, 48, 2)).astype(np.float32),
        kf_ur=rng.uniform(-1, 600, (8, 48)).astype(np.float32),
        kf_level=rng.integers(0, 8, (8, 48)).astype(np.int32),
        kf_frame_id=rng.permutation(8).astype(np.int32) * 3,
        pt_valid=rng.random(96) < 0.9)
    return arrays


@pytest.mark.parametrize("max_obs", [4, 16])
def test_point_major_edges_match_jax(arena, max_obs):
    jm = type(empty_map(MapConfig(max_keyframes=8, max_points=96),
                        OrbConfig(n_features=48)))(
        **{f: jnp.asarray(v) for f, v in arena.items()})
    tm = convert.map_from_jax_numpy(arena)
    je = jba.build_point_major_edges(jm, max_obs=max_obs)
    te = tba.build_point_major_edges(tm, max_obs=max_obs)
    for f in je._fields:
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)), f)
    jk, jd = jba.count_dropped_observations(jm, max_obs=max_obs)
    tk, td = tba.count_dropped_observations(tm, max_obs=max_obs)
    assert (int(tk), int(td)) == (int(jk), int(jd))
    assert (max_obs == 16) == (int(td) == 0)
    perm_j = jba.anchor_block_order(je, jnp.asarray(arena["kf_frame_id"]))
    perm_t = tba.anchor_block_order(te, t(arena["kf_frame_id"]))
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(
        tba.inverse_permutation(perm_t).numpy(),
        np.asarray(jba.inverse_permutation(perm_j)))


def problem(seed, K=8, Pn=256, O=6, starved=None):
    """tests/test_dist_ba.py's problem, perturbed, as numpy; ``starved``
    leaves that camera fewer than 12 valid edges."""
    rng = np.random.default_rng(seed)
    poses, pts, e = make_problem(rng, K=K, Pn=Pn, O=O)
    poses0, pts0 = perturb(rng, poses, pts)
    e = jba.PointEdges(*[np.asarray(a) for a in e])
    if starved is not None:
        keep = np.flatnonzero(e.cam == starved)[:9]
        valid = e.valid & (e.cam != starved)
        valid.flat[keep] = True
        e = e._replace(valid=valid)
    pt_valid = np.ones(Pn, bool)
    pt_valid[::17] = False
    fixed = np.arange(K) == 0
    return (np.asarray(poses), np.asarray(poses0), np.asarray(pts0), pt_valid,
            e, fixed)


def run_both(prob, dense, **kw):
    _, poses0, pts0, pt_valid, e, fixed = prob
    K = len(poses0)
    kf_valid = np.ones(K, bool)
    j = jba.global_ba(JC, jnp.asarray(poses0), jnp.asarray(kf_valid),
                      jnp.asarray(pts0), jnp.asarray(pt_valid),
                      jba.PointEdges(*map(jnp.asarray, e)), jnp.asarray(fixed),
                      dense=dense, **kw)
    tr = tba.global_ba(TC, t(poses0), t(kf_valid), t(pts0), t(pt_valid),
                       tba.PointEdges(*map(t, e)), t(fixed), dense=dense, **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in tr]


@pytest.mark.parametrize("dense,iters", [(False, 2), (True, 5)])
def test_global_ba_matches_jax(dense, iters):
    """PCG is compared over 2 LM iterations: near convergence the
    accept test compares chi2 values equal to float32 rounding, and one
    side's accepted step against the other's rejected one parts the
    results (over 5 iterations with 24-48 CG steps, up to 2.3e-4 in a
    pose, while chi2 agrees within 1e-6 relative)."""
    prob = problem(0)
    (jp, jx, jc), (tp, tx, tc) = run_both(prob, dense, iters=iters)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(tx, jx, atol=1e-3)
    np.testing.assert_allclose(tc, jc, rtol=1e-3)
    # and it converges: every free camera within 3e-3 of the truth
    if not dense:
        _, tr = run_both(prob, dense, iters=5)
        tp = tr[0]
    truth = prob[0]
    for c in range(1, len(truth)):
        err = jse3.se3_log(jse3.se3_compose(jnp.asarray(tp[c]),
                                            jse3.se3_inverse(truth[c])))
        assert float(jnp.linalg.norm(err)) < 3e-3, c


def test_global_ba_pins_starved_cameras():
    """A camera with fewer than 12 inlier edges stays where it was on
    both sides, the others move."""
    prob = problem(1, starved=3)
    (jp, jx, _), (tp, tx, _) = run_both(prob, False, iters=3)
    poses0 = prob[1]
    np.testing.assert_array_equal(tp[3], poses0[3])
    np.testing.assert_array_equal(jp[3], poses0[3])
    assert np.abs(tp[4] - poses0[4]).max() > 1e-4
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(tx, jx, atol=1e-3)


def test_dense_schur_covers_every_point():
    """The dense path's assembly in chunks that do not divide the point
    count (300 points, chunks of 128: 128 + 128 + 44) solves every
    point: it equals the JAX package's one-chunk assembly at this size,
    and a chunked assembly that dropped the remainder would not."""
    prob = problem(2, Pn=300)
    _, poses0, pts0, pt_valid, e, fixed = prob
    te = tba.PointEdges(*map(t, e))
    Hcc, g, D, Hpp_inv, bp, A, _ = tba._linearize(
        TC, t(poses0), t(pts0), te, te.valid & t(pt_valid)[:, None],
        torch.tensor(1e-4))
    free = ~t(fixed)
    full = tba._assemble_schur_dense(Hcc, A, Hpp_inv, te, free, chunk=512)
    chunked = tba._assemble_schur_dense(Hcc, A, Hpp_inv, te, free, chunk=128)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-3)
    cut = tba._assemble_schur_dense(Hcc, A[:256], Hpp_inv[:256],
                                    tba.PointEdges(*[a[:256] for a in te]),
                                    free, chunk=128)
    assert np.abs(cut.numpy() - full.numpy()).max() > 1.0
    (jp, jx, _), (tp, tx, _) = run_both(prob, True, iters=3)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(tx, jx, atol=1e-3)


# ------------------------------ tests/test_dist_ba.py's cases on the port

def test_point_major_edges_from_map():
    from active_orb_slam2_tpu_torch.config import MapConfig as TMap
    from active_orb_slam2_tpu_torch.config import OrbConfig as TOrb
    from active_orb_slam2_tpu_torch.models.map_state import empty_map as tmap
    m = tmap(TMap(max_keyframes=8, max_points=64), TOrb(n_features=16))
    m.kf_valid[:3] = True
    m.kf_feat_valid[:3] = True
    m.pt_valid[:4] = True
    for (k, f, p) in ((0, 0, 0), (0, 1, 1), (1, 3, 0), (1, 4, 2), (2, 5, 0)):
        m.kf_point[k, f] = p
    m.kf_uv[0, 0] = torch.tensor([10.0, 20.0])
    m.kf_uv[1, 3] = torch.tensor([30.0, 40.0])
    m.kf_uv[2, 5] = torch.tensor([50.0, 60.0])
    e = tba.build_point_major_edges(m, max_obs=4)
    assert int(e.valid[0].sum()) == 3
    assert set(e.cam[0][e.valid[0]].tolist()) == {0, 1, 2}
    assert {tuple(u) for u in e.obs_uvr[0, :3, :2].tolist()} == {
        (10.0, 20.0), (30.0, 40.0), (50.0, 60.0)}
    assert int(e.valid[1].sum()) == 1 and int(e.valid[3].sum()) == 0
    m.kf_valid[:6] = True
    m.kf_feat_valid[:6] = True
    m.kf_point[:6, 8] = 5
    m.pt_valid[5] = True
    assert int(tba.build_point_major_edges(m, max_obs=4).valid[5].sum()) == 4
    kept, dropped = tba.count_dropped_observations(m, max_obs=4)
    assert int(dropped) == 2 and int(kept) == 5 + 4
