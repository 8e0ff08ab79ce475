"""Local mapping's parts on the CPU: the port's against the JAX package's.

Seeded numpy inputs go through both packages: triangulation, the 3x3
closed forms, the map views, the point stats and bundle adjustment.
Then each keyframe-mapping stage runs teacher-forced from the maps the
JAX ``System`` (mapping on) holds at its four keyframe events on the
30-frame orbit of ``test_e2e_rgbd.py``, carried across by
``models/convert.py``.

Where the JAX package's scatters let a masked lane overwrite an active
lane's write (ROADMAP queue 3, item g), the port keeps the active
write; the tests compute those cells and name them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.geometry import linalg3 as jl3
from active_orb_slam2_tpu.geometry import se3 as jse3
from active_orb_slam2_tpu.geometry import triangulation as jtri
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.models import local_mapping as jlm
from active_orb_slam2_tpu.models import map_state as jms
from active_orb_slam2_tpu.models import optimizer as jopt
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu_torch.geometry import linalg3 as tl3
from active_orb_slam2_tpu_torch.geometry import triangulation as ttri
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams as TCam
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models import local_mapping as tlm
from active_orb_slam2_tpu_torch.models import map_state as tms
from active_orb_slam2_tpu_torch.models import optimizer as topt
from tests import test_optimizer as jopt_tests
from tests.test_torch_tracking import CAM, configs, np_fields

torch.set_num_threads(1)

JC, TC = configs()


def T(a):
    """numpy / JAX array -> CPU tensor (uint32 as int32 bits)."""
    return convert.to_torch(np.asarray(a))


def jmap(m_np):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in m_np.items()})


def tmap(m_np):
    return convert.map_from_jax_numpy(m_np)


# ------------------------------------------------------------ geometry

def _project(pose, pw, rng, noise):
    pc = np.asarray(jse3.se3_apply(jnp.asarray(pose), jnp.asarray(pw)))
    uv = np.stack([CAM["fx"] * pc[:, 0] / pc[:, 2] + CAM["cx"],
                   CAM["fy"] * pc[:, 1] / pc[:, 2] + CAM["cy"]], -1)
    return (uv + rng.normal(0.0, noise, uv.shape)).astype(np.float32)


def test_triangulation_matches_jax():
    """Seeded pairs at two baselines, and zero-baseline pairs (the same
    camera, the same pixel) that the rank gate must reject."""
    rng = np.random.default_rng(3)
    N = 1500
    cases = []
    for base in (0.05, 0.3):
        pw = rng.uniform([-2, -1.5, 2], [2, 1.5, 8], (N, 3)).astype(np.float32)
        p1 = np.asarray(jse3.se3_exp(jnp.asarray(
            rng.normal(0, 0.05, 6).astype(np.float32))))
        tw = np.concatenate([rng.normal(0, 0.02, 3), [base, 0.0, 0.0]])
        p2 = np.asarray(jse3.se3_compose(
            jse3.se3_exp(jnp.asarray(tw.astype(np.float32))), p1))
        cases.append((p1, p2, _project(p1, pw, rng, 0.3),
                      _project(p2, pw, rng, 0.3), True))
    uv = rng.uniform([0, 0], [320, 240], (N, 2)).astype(np.float32)
    for tw in (np.zeros(6), np.array([0.1, 0, 0, 0, 0, 0])):
        p = np.asarray(jse3.se3_exp(jnp.asarray(tw.astype(np.float32))))
        cases.append((p, p, uv, uv, False))
    for p1, p2, uv1, uv2, expect_ok in cases:
        xj, okj = jtri.triangulate_pairs(JCam(**CAM).K, p1, p2, uv1, uv2)
        xt, okt = ttri.triangulate_pairs(TCam(**CAM), T(p1), T(p2), T(uv1),
                                         T(uv2))
        okj, xj = np.asarray(okj), np.asarray(xj)
        np.testing.assert_array_equal(okt.numpy(), okj)
        assert okj.mean() > 0.95 if expect_ok else not okj.any()
        # well-conditioned points (near-parallel rays put w near 0 and
        # the point near infinity on both sides, far apart)
        rng_m = np.linalg.norm(xj, axis=-1)
        sane = okj & (rng_m < 50.0)
        rel = (np.abs(xt.numpy() - xj).max(-1) / rng_m)[sane]
        assert sane.sum() > 0.9 * okj.sum() if expect_ok else True
        assert rel.max(initial=0.0) <= 1e-4, rel.max()


def test_jacobi_eigh4_matches_eigh():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(256, 4, 4))
    A = A @ np.swapaxes(A, 1, 2)
    vals, vecs = ttri.jacobi_eigh4(torch.from_numpy(A))
    ref_vals, ref_vecs = np.linalg.eigh(A)
    np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=1e-10,
                               atol=1e-10)
    # eigenvectors up to sign
    dots = np.abs(np.einsum("nij,nij->nj", vecs.numpy(), ref_vecs))
    np.testing.assert_allclose(dots, 1.0, atol=1e-8)


def test_inv3_solve3_match_jax():
    rng = np.random.default_rng(5)
    A = (rng.normal(size=(512, 3, 3)) + 3.0 * np.eye(3)).astype(np.float32)
    b = rng.normal(size=(512, 3)).astype(np.float32)
    A[:8] *= 1e-12                          # determinants under the floor
    for eps in (0.0, 1e-30):
        ij = np.asarray(jl3.inv3(A, eps=eps))
        it = tl3.inv3(T(A), eps=eps).numpy()
        np.testing.assert_allclose(it, ij, rtol=1e-6)
        sj = np.asarray(jl3.solve3(A, b, eps=eps))
        st = tl3.solve3(T(A), T(b), eps=eps).numpy()
        np.testing.assert_allclose(st, sj, rtol=1e-6,
                                   atol=1e-6 * np.abs(sj).max())


# ------------------------------------------------------------ map views

def random_map(seed, K=8, P=64, F=16, n_shared=6):
    """A seeded arena: random observations (some points seen by more
    than 12 keyframes' features), poses, positions, descriptors, levels."""
    rng = np.random.default_rng(seed)
    from active_orb_slam2_tpu.config import MapConfig, OrbConfig
    m = np_fields(jms.empty_map(MapConfig(max_keyframes=K, max_points=P),
                                OrbConfig(n_features=F, n_levels=4)))
    kfp = rng.integers(-1, P, (K, F)).astype(np.int32)
    kfp[rng.random((K, F)) < 0.3] = -1
    kfp[:, :n_shared] = np.arange(n_shared)       # widely shared points
    m["kf_point"] = kfp
    m["kf_valid"] = rng.random(K) < 0.85
    m["kf_valid"][:2] = True
    m["pt_valid"] = rng.random(P) < 0.9
    m["kf_feat_valid"] = rng.random((K, F)) < 0.9
    tw = rng.normal(0, 0.1, (K, 6)).astype(np.float32)
    m["kf_pose"] = np.asarray(jse3.se3_exp(jnp.asarray(tw)))
    m["pt_xyz"] = rng.uniform([-2, -1.5, 3], [2, 1.5, 8], (P, 3)).astype(
        np.float32)
    m["kf_desc"] = rng.integers(0, 2 ** 32, (K, F, 8), dtype=np.uint32)
    m["kf_desc"][:, 1] = m["kf_desc"][0, 1]       # ties in the medoid
    m["kf_level"] = rng.integers(0, 4, (K, F)).astype(np.int32)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_views_match_jax(seed):
    m_np = random_map(seed, K=20, P=64, F=16)
    mj, mt = jmap(m_np), tmap(m_np)
    np.testing.assert_array_equal(tms.observation_indicator(mt).numpy(),
                                  np.asarray(jms.observation_indicator(mj)))
    np.testing.assert_array_equal(tms.point_observation_count(mt).numpy(),
                                  np.asarray(jms.point_observation_count(mj)))
    np.testing.assert_array_equal(tms.covisibility_weights(mt).numpy(),
                                  np.asarray(jms.covisibility_weights(mj)))
    for k in range(mt.max_keyframes):
        for min_w in (0, 3):
            it, wt = tms.best_covisible(mt, k, 5, min_weight=min_w)
            ij, wj = jms.best_covisible(mj, k, 5, min_weight=min_w)
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
            np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_point_stats_matches_jax(seed):
    m_np = random_map(seed, K=20, P=64, F=16)
    sj = np_fields(jms.update_point_stats(jmap(m_np)))
    st = convert.map_to_jax_numpy(tms.update_point_stats(tmap(m_np)))
    np.testing.assert_array_equal(st["pt_desc"], sj["pt_desc"])
    for f in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(st[f], sj[f], rtol=1e-5, atol=1e-5)
    # the capped observer lists themselves
    dj, vj = jms.point_observer_descriptors(jmap(m_np))
    dt, vt = tms.point_observer_descriptors(tmap(m_np))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(dt.numpy().view(np.uint32), np.asarray(dj))


# ------------------------------------------------------- bundle adjustment

TCAM_BA = TCam(**jopt_tests.CAM._asdict())


def _ba_inputs(rng, kind):
    poses_true, pts_true, edges = jopt_tests._make_ba_problem(
        rng, noise=0.2 if kind == "outliers" else 0.0)
    fixed = jnp.array([True, False, False, False])
    if kind == "recovery":
        poses0 = jax.vmap(jse3.se3_compose)(jax.vmap(jse3.se3_exp)(jnp.array(
            rng.normal(size=(4, 6)).astype(np.float32) * 0.01)), poses_true)
        poses0 = poses0.at[0].set(poses_true[0])
        pts0 = pts_true + jnp.array(
            rng.normal(size=pts_true.shape).astype(np.float32) * 0.05)
        return poses0, pts0, edges, fixed
    bad = np.zeros(edges.valid.shape[0], bool)
    bad[::17] = True
    obs = np.asarray(edges.obs_uvr).copy()
    obs[bad] += 50.0
    return poses_true, pts_true, edges._replace(obs_uvr=jnp.array(obs)), fixed


def _t_edges(edges):
    return topt.BAEdges(*[T(x) for x in edges])


def _check_ba(rt, rj):
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses),
                               atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points),
                               atol=1e-4)
    agree = (rt.edge_inliers.numpy() == np.asarray(rj.edge_inliers)).mean()
    assert agree >= 0.99, agree


@pytest.mark.parametrize("kind", ["recovery", "outliers"])
def test_bundle_adjustment_matches_jax(kind):
    poses0, pts0, edges, fixed = _ba_inputs(np.random.default_rng(0), kind)
    rj = jopt.bundle_adjustment(jopt_tests.CAM, poses0, pts0, edges, fixed)
    rt = topt.bundle_adjustment(TCAM_BA, T(poses0), T(pts0),
                                _t_edges(edges), T(fixed))
    _check_ba(rt, rj)
    if kind == "outliers":
        bad = np.zeros(edges.valid.shape[0], bool)
        bad[::17] = True
        assert rt.edge_inliers.numpy()[bad].sum() == 0


def test_ba_schur_step_matches_jax_and_dense_oracle():
    rng = np.random.default_rng(0)
    poses, pts, edges = jopt_tests._make_ba_problem(rng, n_cams=3, n_pts=10,
                                                    noise=0.5)
    fixed = jnp.array([True, False, False])
    dcj, dpj, cj = jopt._ba_solve_step(jopt_tests.CAM, poses, pts, edges,
                                       fixed, edges.valid, jnp.float32(1e-5),
                                       use_huber=True)
    te = _t_edges(edges)
    dct, dpt, ct = topt._ba_solve_step(
        TCAM_BA, T(poses), T(pts), te, T(fixed), te.valid,
        torch.full((), 1e-5))
    np.testing.assert_allclose(dct.numpy(), np.asarray(dcj), atol=1e-4)
    np.testing.assert_allclose(dpt.numpy(), np.asarray(dpj), atol=1e-4)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
    # the dense normal equations, damped and pinned the same way
    r, Jc, Jx, w, _, _ = topt._ba_linearize(TCAM_BA, T(poses), T(pts), te,
                                            te.valid)
    Jc = Jc.numpy() * (~np.asarray(fixed))[np.asarray(edges.cam_idx)][
        :, None, None]
    Jx, r, w = Jx.numpy(), r.numpy(), w.numpy()
    nC, nP = 18, 30
    H = np.zeros((nC + nP, nC + nP))
    b = np.zeros(nC + nP)
    for e in range(r.shape[0]):
        c, p = int(edges.cam_idx[e]), int(edges.pt_idx[e])
        J = np.zeros((3, nC + nP))
        J[:, 6 * c:6 * c + 6] = Jc[e]
        J[:, nC + 3 * p:nC + 3 * p + 3] = Jx[e]
        H += w[e] * J.T @ J
        b -= w[e] * J.T @ r[e]
    H += np.diag(1e-5 * np.diag(H)) + 1e-6 * np.eye(nC + nP)
    H[:6, :] = 0
    H[:, :6] = 0
    H[:6, :6] = np.eye(6)
    b[:6] = 0
    delta = np.linalg.solve(H, b)
    np.testing.assert_allclose(dct.numpy().ravel(), delta[:nC], atol=5e-4)
    np.testing.assert_allclose(dpt.numpy().ravel(), delta[nC:], atol=5e-4)


# --------------------------------------------- teacher-forced mapping stages

@pytest.fixture(scope="module")
def events():
    """(map, kf_slot, kf_seq) at each keyframe-mapping call of the JAX
    System on the 30-frame orbit, as numpy.  Each frame retires before
    the next is tracked, so the events do not depend on timing."""
    slam = jsys.System(JC, pipeline_depth=0, retire_batch=1)
    recs = []
    run = slam.keyframe_mapping

    def record(m, k, seq):
        recs.append((np_fields(m), int(k), int(seq)))
        return run(m, k, seq)

    slam.keyframe_mapping = record
    for i, (g, d, _) in enumerate(jsyn.make_sequence(
            30, JC.camera, world=jsyn.default_world(),
            trajectory=jsyn.orbit_trajectory(30, step_deg=2.0))):
        slam.track_rgbd(g, d, i / 30.0)
    slam.flush()
    assert len(recs) == 4 and recs[-1][0]["kf_valid"].sum() == 5
    return recs


@pytest.fixture(scope="module")
def jax_stages():
    return {"create": jlm.build_create_new_map_points(JC),
            "fuse": jlm.build_fuse_neighbors(JC),
            "cull": jlm.build_keyframe_culling(JC),
            "cull_forced": jlm.build_keyframe_culling(JC, force=True)}


def collision_cells(kfp_t, kfp_j, kfp_in):
    """The kf_point cells where the two packages differ, checked to be
    the JAX package's masked-lane overwrites: feature 0 of a keyframe
    row, the input value kept by JAX, a new point written by the port.
    Returns them as (slot, feature) pairs."""
    cells = [tuple(int(v) for v in c) for c in np.argwhere(kfp_t != kfp_j)]
    for k, f in cells:
        assert f == 0, (k, f)
        assert kfp_j[k, f] == kfp_in[k, f] and kfp_t[k, f] >= 0, (k, f)
    return cells


def _same_fields(mt, mj, fields):
    t = convert.map_to_jax_numpy(mt)
    for f in fields:
        np.testing.assert_array_equal(t[f], np.asarray(getattr(mj, f)), f)


def _check_create_points(m_np, k, seq, create_j):
    mj = create_j(jmap(m_np), k, seq)
    mt = tlm.build_create_new_map_points(TC)(tmap(m_np), k, seq)
    _same_fields(mt, mj, ("pt_valid", "kf_valid", "kf_parent", "pt_desc",
                          "pt_first_kf", "pt_visible", "pt_found"))
    new = np.asarray(mj.pt_valid) & ~m_np["pt_valid"]
    for f in ("pt_xyz", "pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(mt, f).numpy()[new],
                                   np.asarray(getattr(mj, f))[new],
                                   rtol=1e-4, atol=1e-4)
    cells = collision_cells(mt.kf_point.numpy(), np.asarray(mj.kf_point),
                            m_np["kf_point"])
    assert len(cells) <= 1, cells        # (nbrs[0], 0) at most
    return int(new.sum()), cells


@pytest.mark.parametrize("event", [0, 1, 2, 3])
def test_create_points_teacher_forced(events, jax_stages, event):
    """On the orbit neither package creates a point: the reference's
    epipolar gate pairs the wrong features (ROADMAP queue 3, item h)."""
    m_np, k, seq = events[event]
    n_new, cells = _check_create_points(m_np, k, seq, jax_stages["create"])
    assert n_new == 0 and cells == []


def aligned_map(seed):
    """Three keyframes 0.15 m apart whose feature i is the projection of
    3D point i in each, so the reference's epipolar gate (which reads the
    line of feature j against feature i of the neighbour) holds for the
    true pairs.  Features 0-23 already track points (the covisibility);
    the rest are free and get triangulated."""
    rng = np.random.default_rng(seed)
    from active_orb_slam2_tpu.config import MapConfig, OrbConfig
    K, P, F = 8, 1024, 512
    m = {f: v.copy() for f, v in np_fields(jms.empty_map(
        MapConfig(max_keyframes=K, max_points=P),
        OrbConfig(n_features=F, n_levels=4))).items()}
    pw = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0], (F, 3)).astype(
        np.float32)
    desc = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    for k in range(3):
        tw = np.array([0, 0.02 * k, 0, 0.15 * k, 0.01 * k, 0], np.float32)
        pose = np.asarray(jse3.se3_exp(jnp.asarray(tw)))
        m["kf_pose"][k] = pose
        m["kf_uv"][k] = _project(pose, pw, rng, 0.2)
        flip = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32) & \
            rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32) & \
            rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32) & \
            np.uint32(0x01010101)
        m["kf_desc"][k] = desc ^ flip
        m["kf_level"][k] = rng.integers(0, 3, F)
        m["kf_frame_id"][k] = 10 * k
    m["kf_valid"][:3] = True
    m["kf_feat_valid"][:3] = True
    m["kf_point"][:3, :24] = np.arange(24)
    m["kf_parent"][1:3] = [0, 1]
    m["pt_valid"][:24] = True
    m["pt_xyz"][:24] = pw[:24]
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_create_points_on_aligned_keyframes(jax_stages, seed):
    n_new, cells = _check_create_points(aligned_map(seed), 2, 3,
                                        jax_stages["create"])
    assert n_new >= 30, n_new


@pytest.mark.parametrize("event", [0, 1, 2, 3])
def test_fuse_teacher_forced(events, jax_stages, event):
    m_np, k, _ = events[event]
    mj = jax_stages["fuse"](jmap(m_np), k)
    mt = tlm.build_fuse_neighbors(TC)(tmap(m_np), k)
    _same_fields(mt, mj, ("pt_valid", "kf_valid", "kf_parent"))
    cells = collision_cells(mt.kf_point.numpy(), np.asarray(mj.kf_point),
                            m_np["kf_point"])
    assert len(cells) <= 8, cells        # (n, 0) per neighbour at most


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("event", [1, 3])
def test_keyframe_culling_teacher_forced(events, jax_stages, event, force):
    m_np, k, _ = events[event]
    mj, vj = jax_stages["cull_forced" if force else "cull"](jmap(m_np), k)
    mt, vt = tlm.build_keyframe_culling(TC, force=force)(tmap(m_np), k)
    assert int(vt) == int(vj)
    _same_fields(mt, mj, ("kf_point", "kf_valid", "kf_parent", "pt_valid"))


def test_keyframe_culling_rules_match_jax():
    """The scale-condition and forced-eviction maps of
    ``test_map_state.py`` through both packages."""
    from active_orb_slam2_tpu import config as jcfg
    from active_orb_slam2_tpu_torch import config as tcfg
    cam = dict(fx=100., fy=100., cx=32., cy=32., bf=10., width=64, height=64)

    def make(mod, camcls):
        return mod.SlamConfig(camera=camcls(**cam),
                              orb=mod.OrbConfig(n_features=24, n_levels=4),
                              map=mod.MapConfig(max_keyframes=8,
                                                max_points=64))
    jc, tc = make(jcfg, JCam), make(tcfg, TCam)
    rng = np.random.default_rng(6)
    for trial in range(6):
        m = np_fields(jms.empty_map(jc.map, jc.orb))
        kfp = np.full((8, 24), -1, np.int32)
        kfp[:6, :12] = np.arange(12)
        kfp[:6, 12:12 + trial] = 12 + np.arange(6 * trial).reshape(6, trial)
        m.update(kf_point=kfp, kf_valid=np.arange(8) < 6,
                 kf_feat_valid=np.ones((8, 24), bool),
                 pt_valid=np.ones(64, bool),
                 kf_level=rng.integers(0, 4, (8, 24)).astype(np.int32),
                 kf_frame_id=rng.permutation(8).astype(np.int32),
                 kf_parent=np.array([-1, 0, 0, 1, 2, 3, -1, -1], np.int32))
        for force in (False, True):
            k = int(rng.integers(0, 6))
            mj, vj = jlm.build_keyframe_culling(jc, force=force)(jmap(m), k)
            mt, vt = tlm.build_keyframe_culling(tc, force=force)(tmap(m), k)
            assert int(vt) == int(vj), (trial, force)
            _same_fields(mt, mj, ("kf_point", "kf_valid", "kf_parent"))


def test_mapping_step_matches_jax_without_repeated_cameras(events):
    """With a 2-keyframe window on the 5-keyframe map no camera appears
    twice in the window, so the JAX write-back loses nothing and the two
    packages agree."""
    jc2 = dataclasses.replace(JC, map=dataclasses.replace(
        JC.map, local_ba_keyframes=2))
    tc2 = dataclasses.replace(TC, map=dataclasses.replace(
        TC.map, local_ba_keyframes=2))
    m_np, k, seq = events[-1]
    mt_in = tmap(m_np)
    W = tms.covisibility_weights(mt_in)
    cams, cams_ok = tlm.local_ba_window(
        tc2, tlm.cull_map_points(mt_in, seq), k, W)[:2]
    live = cams.numpy()[cams_ok.numpy()]
    assert len(set(cams.numpy().tolist())) == len(cams) == 4 and len(live) == 4
    mj = jlm.build_mapping_step(jc2)(jmap(m_np), k, seq)
    mt = tlm.build_mapping_step(tc2)(tmap(m_np), k, seq)
    _same_fields(mt, mj, ("pt_valid", "kf_valid", "kf_parent", "kf_point",
                          "pt_desc"))
    assert np.abs(np.asarray(mj.kf_pose) - m_np["kf_pose"]).max() > 0
    np.testing.assert_allclose(mt.kf_pose.numpy(), np.asarray(mj.kf_pose),
                               atol=1e-4)
    # points within 1e-3 m: a poorly constrained point can take another
    # LM path when float sums run in another order
    np.testing.assert_allclose(mt.pt_xyz.numpy(), np.asarray(mj.pt_xyz),
                               atol=1e-3)
    for f in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(mt, f).numpy(),
                                   np.asarray(getattr(mj, f)), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("moved", [False, True])
def test_local_ba_writeback(events, moved):
    """The port's mapping step writes back exactly what the JAX
    ``bundle_adjustment`` computes on the port's window.  With the new
    keyframe moved 1 cm in x (``moved``), the JAX ``build_mapping_step``
    leaves every keyframe pose as it was, since each local camera
    reappears as a masked lane of the fixed ring; the port moves the
    keyframe back to where the port's BA takes it from its tracked pose.
    """
    m_np, k, seq = events[-1]
    m_np = dict(m_np, kf_pose=m_np["kf_pose"].copy())
    settled = tlm.build_mapping_step(TC)(tmap(m_np), k, seq).kf_pose[k]
    if moved:
        m_np["kf_pose"][k, 4] += 0.01
    m_t = tmap(m_np)
    W = tms.covisibility_weights(m_t)
    culled = tlm.cull_map_points(m_t, seq)
    cams, cams_ok, fixed, pt_sel, pt_sel_ok, edges = tlm.local_ba_window(
        TC, culled, k, W)
    out = tlm.build_mapping_step(TC)(tmap(m_np), k, seq)
    rj = jopt.bundle_adjustment(
        JC.camera, jnp.asarray(culled.kf_pose[cams].numpy()),
        jnp.asarray(culled.pt_xyz[pt_sel].numpy()),
        jopt.BAEdges(*[jnp.asarray(x.numpy()) for x in edges]),
        jnp.asarray((fixed | ~cams_ok).numpy()), iters_a=4, iters_b=8)
    write = (cams_ok & ~fixed).numpy()
    assert write[0], "the new keyframe is a free camera"
    got = out.kf_pose.numpy()[cams.numpy()[write]]
    np.testing.assert_allclose(got, np.asarray(rj.poses)[write], atol=1e-4)
    sel = pt_sel.numpy()[pt_sel_ok.numpy()]
    np.testing.assert_allclose(out.pt_xyz.numpy()[sel],
                               np.asarray(rj.points)[pt_sel_ok.numpy()],
                               rtol=1e-4, atol=1e-4)
    if moved:
        mj = jlm.build_mapping_step(JC)(jmap(m_np), k, seq)
        assert np.abs(np.asarray(mj.kf_pose) - m_np["kf_pose"]).max() == 0.0
        before = np.linalg.norm(m_np["kf_pose"][k, 4:] - settled[4:].numpy())
        after = np.linalg.norm(out.kf_pose.numpy()[k, 4:] - settled[4:].numpy())
        assert after < 0.5 * min(before, 0.01), (before, after)
