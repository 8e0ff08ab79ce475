"""The port's monocular initializer (``models/initializer.py``) beside the
JAX package's: the four cases of ``tests/test_initializer.py`` on the
port, each helper on the same seeded inputs, and the whole initializer
with the JAX package's Gumbel draws.

The JAX package solves the 8-point DLTs with a float32 ``eigh``, the
port in float64.  The fundamental system is ill-conditioned in float32:
in the outlier case the same hypothesis wins the race in both packages,
but the refits part and the poses end 0.096 apart (two float32 LAPACK
builds part the same way).  ``jax_f64_dlt`` gives the JAX package a
float64 solve; with it every case agrees in ``ok``, the model and every
point flag, and the pose within 2e-4.

The outlier case of ``tests/test_initializer.py`` passes its
translation bar (1 - cos < 2e-3) only with the JAX package's float32
solve: with a float64 solve both packages reconstruct the pair with 1 -
cos = 0.0078 (``test_outlier_case_rests_on_float32_rounding``).  The
port lands there too, and also with the JAX package's float32 DLTs
swapped in (0.0081: the 1e-3 differences of the float32 solves move the
translation that far).  So the port's outlier case holds its
translation to the JAX package's float64 reconstruction.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from active_orb_slam2_tpu.geometry import se3_exp
from active_orb_slam2_tpu.models import initializer as jinit
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import (
    se3_compose, se3_inverse, se3_log)
from active_orb_slam2_tpu_torch.models import initializer as tinit
from tests import test_initializer as ref

torch.set_num_threads(1)

CAM = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=0.0,
                   width=640, height=480)
SIGMA2 = (1.0 / CAM.fx) ** 2
GENERAL = [0.02, -0.03, 0.01, 0.4, 0.05, 0.1]
# (twist, pixel noise, PRNGKey) of each case of tests/test_initializer.py
CASES = {"general": (GENERAL, 0.5, 0), "planar": (None, 0.4, 1),
         "rotation": ([0.02, -0.03, 0.04, 0.0, 0.0, 0.0], 0.3, 2),
         "outliers": (GENERAL, 0.4, 3)}


def case(name):
    """The inputs of a case of ``tests/test_initializer.py``, made as it
    makes them from ``default_rng(0)``: (uv1, uv2, bad, T2, key)."""
    rng = np.random.default_rng(0)
    twist, noise, key = CASES[name]
    if name == "planar":
        xy = rng.uniform([-2, -1.5], [2, 1.5], (300, 2)).astype(np.float32)
        pw = np.concatenate([xy, 5.0 + 0.3 * xy[:, :1] + 0.2 * xy[:, 1:]], 1)
        twist = [0.03, -0.02, 0.02, 0.5, 0.1, 0.05]
    else:
        pw = rng.uniform([-2, -1.5, 3], [2, 1.5, 9], (300, 3)).astype(
            np.float32)
    T2 = se3_exp(jnp.array(twist, jnp.float32))
    uv1, uv2 = (np.asarray(a) for a in ref._project_two(pw, T2, noise, rng))
    bad = np.zeros(300, bool)
    if name == "outliers":
        uv2 = uv2.copy()
        bad = rng.random(300) < 0.3
        uv2[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2))
    return (uv1.astype(np.float32), uv2.astype(np.float32), bad,
            np.asarray(T2), jax.random.PRNGKey(key))


def t(a):
    return torch.from_numpy(np.array(a))


def run_port(name):
    uv1, uv2, bad, T2, key = case(name)
    noise = np.asarray(jax.random.gumbel(key, (tinit.N_HYPOTHESES, 300)))
    res = tinit.build_initializer(CAM)(t(noise), t(uv1), t(uv2),
                                       torch.ones(300, dtype=torch.bool))
    return res, bad, T2


def run_jax(name):
    uv1, uv2, _, _, key = case(name)
    return jinit.build_initializer(ref.CAM)(key, jnp.asarray(uv1),
                                            jnp.asarray(uv2),
                                            jnp.ones(300, bool))


def pose_dir_error(pose2, T2):
    """(rotation error rad, 1 - |cos| of the translation directions)."""
    pose2 = torch.as_tensor(np.asarray(pose2))
    T2 = torch.as_tensor(np.asarray(T2))
    rot = torch.cat([pose2[:4], torch.zeros(3)])
    rot_true = torch.cat([T2[:4], torch.zeros(3)])
    r_err = float(torch.linalg.vector_norm(
        se3_log(se3_compose(rot, se3_inverse(rot_true)))[:3]))
    a, b = pose2[4:7], T2[4:7]
    cos = float((a @ b) / (a.norm() * b.norm()).clamp(min=1e-9))
    return r_err, 1.0 - abs(cos)


# ---------------------------------------- tests/test_initializer.py on the port

def test_initializer_general_scene():
    res, _, T2 = run_port("general")
    assert bool(res.ok) and not bool(res.used_h)
    r_err, t_err = pose_dir_error(res.pose2, T2)
    assert r_err < 0.01 and t_err < 1e-3, (r_err, t_err)
    assert int(res.point_ok.sum()) > 200


def test_initializer_planar_scene():
    res, _, T2 = run_port("planar")
    assert bool(res.ok) and bool(res.used_h)
    r_err, t_err = pose_dir_error(res.pose2, T2)
    assert r_err < 0.02 and t_err < 5e-3, (r_err, t_err)


def test_initializer_rejects_pure_rotation():
    res, _, _ = run_port("rotation")
    assert not bool(res.ok)


def test_initializer_with_outliers():
    """The case's bars but its translation bar, which the JAX package
    meets only with its float32 DLT solve (see the module docstring):
    the translation direction is held to the JAX package's float64
    reconstruction instead, within 1e-4."""
    res, bad, T2 = run_port("outliers")
    assert bool(res.ok)
    r_err, t_err = pose_dir_error(res.pose2, T2)
    assert r_err < 0.02, r_err
    assert res.point_ok.numpy()[bad].sum() <= 3
    with jax_f64_dlt():
        want = run_jax("outliers")
    assert abs(t_err - pose_dir_error(want.pose2, T2)[1]) < 1e-4


# ------------------------------------------------------------------ helpers

def normalized(name):
    uv1, uv2, *_ = case(name)
    return ((uv1 - [CAM.cx, CAM.cy]) / CAM.fx).astype(np.float32), \
        ((uv2 - [CAM.cx, CAM.cy]) / CAM.fx).astype(np.float32)


def unit_sign(a):
    """Matrices [..., 3, 3] scaled to unit norm, sign fixed by the entry
    of largest magnitude."""
    a = np.asarray(a, np.float64).reshape(-1, 9)
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    big = np.take_along_axis(a, np.abs(a).argmax(-1)[:, None], -1)
    return a * np.sign(big)


@pytest.mark.parametrize("name", ["general", "planar"])
def test_dlt_matches_jax(name):
    """Both DLTs on 200 8-point sets and the weighted refit over every
    match, the JAX package's with the float64 solve: within 1e-5 of each
    other (up to sign)."""
    x1, x2 = normalized(name)
    picks = np.random.default_rng(5).choice(300, (200, 8))
    w = (np.random.default_rng(6).random(300) < 0.8).astype(np.float32)
    with jax_f64_dlt():
        for fn in ("_dlt_h", "_dlt_f"):
            for args in ((x1[picks], x2[picks]), (x1, x2, w)):
                got = getattr(tinit, fn)(*map(t, args))
                want = getattr(jinit, fn)(*map(jnp.asarray, args))
                np.testing.assert_allclose(unit_sign(got), unit_sign(want),
                                           atol=1e-5, err_msg=fn)


@pytest.mark.parametrize("name", ["general", "planar", "outliers"])
def test_scores_match_jax(name):
    """The H and F scores of the same hypotheses (the JAX package's, fed
    to both): scores within 1e-4 relative, inlier masks equal."""
    x1, x2 = normalized(name)
    picks = np.random.default_rng(5).choice(300, (200, 8))
    valid = np.random.default_rng(7).random(300) < 0.9
    Hs = np.asarray(jinit._dlt_h(jnp.asarray(x1[picks]),
                                 jnp.asarray(x2[picks])))
    Fs = np.asarray(jinit._dlt_f(jnp.asarray(x1[picks]),
                                 jnp.asarray(x2[picks])))
    for fn, M in (("_h_score", Hs), ("_f_score", Fs)):
        ws, wm = getattr(jinit, fn)(jnp.asarray(M), jnp.asarray(x1)[None],
                                    jnp.asarray(x2)[None],
                                    jnp.asarray(valid)[None], SIGMA2)
        gs, gm = getattr(tinit, fn)(t(M), t(x1), t(x2), t(valid), SIGMA2)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-4,
                                   atol=1e-9, err_msg=fn)
        assert (gm.numpy() == np.asarray(wm)).mean() >= 0.9999, fn


def test_decompositions_match_jax():
    """The 4 E and 8 H candidates of the same matrices (the JAX package's
    refit models of the general and the planar case): every rotation and
    translation within 1e-4 of the JAX package's, in the same order."""
    for name, fn in (("general", "_decompose_e"), ("planar", "_decompose_h")):
        x1, x2 = normalized(name)
        dlt = jinit._dlt_f if fn == "_decompose_e" else jinit._dlt_h
        M = np.asarray(dlt(jnp.asarray(x1), jnp.asarray(x2),
                           jnp.ones(300, jnp.float32)))
        wR, wt = getattr(jinit, fn)(jnp.asarray(M))
        gR, gt = getattr(tinit, fn)(t(M))
        np.testing.assert_allclose(gR.numpy(), np.asarray(wR), atol=1e-4,
                                   err_msg=fn)
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-4,
                                   err_msg=fn)


def test_check_rt_matches_jax():
    """CheckRT under the 12 candidates of the general case: the vote masks
    within 0.5% (the JAX package triangulates with a float32 ``eigh``,
    the port with float64 Jacobi sweeps; ROADMAP queue 3, item i), the
    points of the best candidate within 1e-3 relative."""
    x1, x2 = normalized("general")
    F = jinit._dlt_f(jnp.asarray(x1), jnp.asarray(x2), jnp.ones(300))
    H = jinit._dlt_h(jnp.asarray(x1), jnp.asarray(x2), jnp.ones(300))
    Rh, th = jinit._decompose_h(H)
    Rf, tf = jinit._decompose_e(F)
    R = np.asarray(jnp.concatenate([Rh, Rf]))
    tt = np.asarray(jnp.concatenate([th, tf]))
    valid = np.ones(300, bool)
    wg, wx, wc = jinit._check_rt(jnp.asarray(R), jnp.asarray(tt),
                                 jnp.asarray(x1), jnp.asarray(x2),
                                 jnp.asarray(valid), SIGMA2)
    gg, gx, gc = tinit._check_rt(t(R), t(tt), t(x1), t(x2), t(valid), SIGMA2)
    wg = np.asarray(wg)
    assert (gg.numpy() == wg).mean() >= 0.995
    best = int(wg.sum(-1).argmax())
    ok = wg[best] & gg.numpy()[best]
    np.testing.assert_allclose(gx.numpy()[best][ok], np.asarray(wx)[best][ok],
                               rtol=1e-3)
    np.testing.assert_allclose(gc.numpy()[best][ok], np.asarray(wc)[best][ok],
                               atol=1e-6)


# ---------------------------------------------------- the whole initializer

@pytest.mark.parametrize("name", ["general", "planar", "rotation"])
def test_initializer_matches_jax(name):
    """Same inputs and noise: the same verdict and model, every point flag
    within 1%, the pose within 5e-3 (measured up to 2.3e-3: the float32
    F solves of the two LAPACK builds), the points within 1e-2 relative."""
    res, _, _ = run_port(name)
    want = run_jax(name)
    assert bool(res.ok) == bool(want.ok)
    assert bool(res.used_h) == bool(want.used_h)
    assert (res.point_ok.numpy() == np.asarray(want.point_ok)).mean() >= 0.99
    np.testing.assert_allclose(res.pose2.numpy(), np.asarray(want.pose2),
                               atol=5e-3)
    ok = res.point_ok.numpy() & np.asarray(want.point_ok)
    np.testing.assert_allclose(res.points.numpy()[ok],
                               np.asarray(want.points)[ok], rtol=1e-2)


def f64_eigvec(a):
    """Smallest-eigenvalue eigenvector of symmetric [..., n, n] by a
    float64 ``eigh``, its largest component made positive; float32."""
    _, v = np.linalg.eigh(np.asarray(a, np.float64))
    v = v[..., :, 0]
    big = np.take_along_axis(v, np.abs(v).argmax(-1)[..., None], -1)
    return (v * np.sign(big)).astype(np.float32)


def _jax_dlt(rows):
    """A JAX DLT whose eigenvector comes from ``f64_eigvec``."""
    def dlt(x1, x2, w=None):
        A = rows(x1, x2)
        Aw = A if w is None else A * (jnp.concatenate([w, w], -1)
                                      if A.shape[-2] == 2 * x1.shape[-2]
                                      else w)[..., None]
        AtA = jnp.einsum('...ji,...jk->...ik', Aw, A)
        return jax.pure_callback(
            f64_eigvec, jax.ShapeDtypeStruct(AtA.shape[:-1], jnp.float32),
            AtA).reshape(A.shape[:-2] + (3, 3))
    return dlt


def _h_rows(x1, x2):
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    o, z = jnp.ones_like(u), jnp.zeros_like(u)
    return jnp.concatenate([
        jnp.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], -1),
        jnp.stack([u, v, o, z, z, z, -up * u, -up * v, -up], -1)], -2)


def _f_rows(x1, x2):
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    return jnp.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v,
                      jnp.ones_like(u)], -1)


def _jax_dlt_f(x1, x2, w=None):
    F = _jax_dlt(_f_rows)(x1, x2, w)
    U, s, Vt = jnp.linalg.svd(F)
    return U @ (s.at[..., 2].set(0.0)[..., None] * Vt)


@contextlib.contextmanager
def jax_f64_dlt():
    """Inside the ``with``, the JAX package's DLTs take their eigenvector
    from a float64 ``eigh`` (``f64_eigvec``), as the port's do."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinit, "_dlt_h", _jax_dlt(_h_rows))
        mp.setattr(jinit, "_dlt_f", _jax_dlt_f)
        yield


def test_outlier_case_rests_on_float32_rounding():
    """The named cause of the outlier case's float32 dependence: with a
    float64 DLT solve, the JAX package's own reconstruction misses the
    case's translation bar (1 - cos < 2e-3; measured 0.0078), and the
    port's lands within 1e-4 of it; the rotation bar still holds."""
    res, _, T2 = run_port("outliers")
    with jax_f64_dlt():
        want = run_jax("outliers")
    r_port, t_port = pose_dir_error(res.pose2, T2)
    r_jax, t_jax = pose_dir_error(want.pose2, T2)
    assert t_jax > 2e-3 and abs(t_port - t_jax) < 1e-4, (t_port, t_jax)
    assert r_port < 0.02 and r_jax < 0.02


@pytest.mark.parametrize("name", ["general", "planar", "rotation",
                                  "outliers"])
def test_initializer_f64_dlt_matches_jax(name):
    """With the JAX package's DLTs solved in float64, every case agrees:
    the same verdict and model, every point flag equal, the pose within
    2e-4 (measured up to 1.3e-4 with the float32 SVDs left in place:
    3.7e-5 general, 2.5e-6 planar, 1.3e-4 rotation, 1.9e-5 outliers),
    the points within 1e-3 relative."""
    res, _, _ = run_port(name)
    with jax_f64_dlt():
        want = run_jax(name)
    assert bool(res.ok) == bool(want.ok)
    assert bool(res.used_h) == bool(want.used_h)
    np.testing.assert_array_equal(res.point_ok.numpy(),
                                  np.asarray(want.point_ok))
    np.testing.assert_allclose(res.pose2.numpy(), np.asarray(want.pose2),
                               atol=2e-4)
    ok = res.point_ok.numpy()
    np.testing.assert_allclose(res.points.numpy()[ok],
                               np.asarray(want.points)[ok], rtol=1e-3)
