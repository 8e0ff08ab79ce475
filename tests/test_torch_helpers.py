"""The JAX package's small public helpers that the port now has, each
against the JAX function on the same inputs: ``backproject`` and
``CameraParams.K``, ``umeyama_alignment`` in ``geometry/horn.py``,
``gaussian_blur`` and ``pad_image``, ``ARC_LEN``,
``apply_visibility_counters`` and the synchronous
``LoopCloser.detect``.

Tolerances: float32 arithmetic in the same order is held to 1e-6
relative (``backproject``) or 1e-4 grey levels (the blur's 14 products
and sums of values up to 255); the alignment, float64 numpy on the port
and float32 on the JAX side, to 1e-4; integers, padding, the intrinsic
matrix and loop decisions exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.geometry import horn as jhorn
from active_orb_slam2_tpu.geometry import projection as jproj
from active_orb_slam2_tpu.geometry.se3 import quat_to_mat
from active_orb_slam2_tpu.models import loop_closing as jlc
from active_orb_slam2_tpu.models import tracking as jtrack
from active_orb_slam2_tpu.ops import fast as jfast
from active_orb_slam2_tpu.ops import image as jimage
from active_orb_slam2_tpu_torch.geometry import horn as thorn
from active_orb_slam2_tpu_torch.geometry import projection as tproj
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models import loop_closing as tlc
from active_orb_slam2_tpu_torch.models import tracking as ttrack
from active_orb_slam2_tpu_torch.ops import fast as tfast
from active_orb_slam2_tpu_torch.ops import image as timage
from active_orb_slam2_tpu_torch.utils import evaluate
from tests.test_torch_long_run import (
    CLOSE_EVENT, GUARD, N_LAP1, jmap, live_arena, loop_arena, loop_configs)
from tests.test_torch_tracking import CAM

torch.set_num_threads(1)


def test_backproject_and_K_match_jax():
    rng = np.random.default_rng(0)
    uv = rng.uniform([0, 0], [320, 240], (200, 2)).astype(np.float32)
    z = rng.uniform(0.3, 8.0, 200).astype(np.float32)
    jc, tc = jproj.CameraParams(**CAM), tproj.CameraParams(**CAM)
    j = np.asarray(jproj.backproject(jc, jnp.asarray(uv), jnp.asarray(z)))
    t = tproj.backproject(tc, torch.from_numpy(uv), torch.from_numpy(z))
    assert t.shape == (200, 3) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)
    # the inverse of the projection
    uv_back, depth = tproj.project(tc, t)
    np.testing.assert_allclose(uv_back.numpy(), uv, atol=1e-3)
    np.testing.assert_allclose(depth.numpy(), z, rtol=0, atol=0)
    assert tc.K.dtype == torch.float32
    assert np.array_equal(tc.K.numpy(), np.asarray(jc.K))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_umeyama_alignment_matches_jax(fix_scale):
    rng = np.random.default_rng(1)
    src = rng.normal(0, 1, (60, 3))
    a = 0.4
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    dst = 1.3 * src @ R.T + [0.2, -0.1, 0.5] + rng.normal(0, 0.01, (60, 3))
    aligned, R_t, t_t, s_t, rmse_t = thorn.umeyama_alignment(
        src, dst, fix_scale=fix_scale)
    assert evaluate.umeyama_alignment is thorn.umeyama_alignment
    ja, jq, jt, js, jrmse = (np.asarray(v) for v in jhorn.umeyama_alignment(
        jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32),
        fix_scale=fix_scale))
    np.testing.assert_allclose(aligned, ja, atol=1e-4)
    np.testing.assert_allclose(R_t, np.asarray(quat_to_mat(jq)), atol=1e-4)
    np.testing.assert_allclose(t_t, jt, atol=1e-4)
    np.testing.assert_allclose(s_t, js, atol=1e-4)
    np.testing.assert_allclose(rmse_t, jrmse, atol=1e-4)


@pytest.mark.parametrize("shape", [(240, 320), (37, 53)])
def test_gaussian_blur_and_pad_match_jax(shape):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    t = timage.gaussian_blur(torch.from_numpy(img))
    j = np.asarray(jimage.gaussian_blur(jnp.asarray(img)))
    assert t.shape == shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-4)
    for pad in (1, 19):
        tp = timage.pad_image(torch.from_numpy(img), pad).numpy()
        assert np.array_equal(tp, np.asarray(jimage.pad_image(
            jnp.asarray(img), pad)))
    # a constant image blurs to itself (the taps sum to one)
    flat = timage.gaussian_blur(torch.full(shape, 7.0))
    np.testing.assert_allclose(flat.numpy(), 7.0, atol=1e-5)


def test_arc_len():
    assert tfast.ARC_LEN == jfast.ARC_LEN == 9


def test_apply_visibility_counters_matches_jax():
    arrays = loop_arena()[0]
    rng = np.random.default_rng(3)
    P = arrays["pt_valid"].shape[0]
    vis, found = rng.random(P) < 0.3, rng.random(P) < 0.1
    jm = jtrack.apply_visibility_counters(jmap(arrays), jnp.asarray(vis),
                                          jnp.asarray(found))
    tm = convert.map_from_jax_numpy(arrays)
    out = ttrack.apply_visibility_counters(tm, torch.from_numpy(vis),
                                           torch.from_numpy(found))
    assert out is tm
    assert np.array_equal(tm.pt_visible.numpy(), np.asarray(jm.pt_visible))
    assert np.array_equal(tm.pt_found.numpy(), np.asarray(jm.pt_found))


def test_loop_closer_detect_matches_jax():
    """``LoopCloser.detect`` on both sides over the second lap's events of
    ``tests/test_torch_long_run.py``'s arena (one consistent group
    enough, the 512-word vocabulary): the same candidate or -1 at every
    event, and the first lap's place found."""
    arrays = live_arena(loop_arena()[0], N_LAP1)
    jc, tc = loop_configs()
    kw = dict(consistency_th=1, recent_frames_guard=GUARD)
    jl, tl = jlc.LoopCloser(jc, **kw), tlc.LoopCloser(tc, **kw)
    jm, tm = jmap(arrays), convert.map_from_jax_numpy(arrays)
    jdec, tdec = [], []
    for s in range(N_LAP1, CLOSE_EVENT):
        jm = jm._replace(kf_valid=jm.kf_valid.at[s].set(True))
        tm.kf_valid[s] = True
        # a live count below the retrain's keeps the 512-word vocabulary
        jdec.append(jl.detect(jm, s, n_live_kf=5))
        tdec.append(tl.detect(tm, s, n_live_kf=5))
    assert tl.vocab.n_words == jl.vocab.n_words
    assert tdec == jdec
    assert any(0 <= c < N_LAP1 for c in tdec), tdec
