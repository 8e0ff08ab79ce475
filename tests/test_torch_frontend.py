"""The port's ORB front end against the JAX package, on the CPU.

Inputs are made with numpy (the synthetic orbit of ``test_e2e_rgbd.py``
at 320x240, or seeded random data) and fed to both packages; the JAX
Pallas patch kernel runs in interpret mode, as the JAX package's own
tests run it here.  Descriptors compare through their uint32 bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.config import OrbConfig as JOrbConfig
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.ops import fast as jfast
from active_orb_slam2_tpu.ops import image as jimage
from active_orb_slam2_tpu.ops import matching as jmatch
from active_orb_slam2_tpu.ops import orb as jorb
from active_orb_slam2_tpu.ops import patches as jpatches
from active_orb_slam2_tpu_torch.config import OrbConfig
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.io import synthetic as tsyn
from active_orb_slam2_tpu_torch.ops import fast as tfast
from active_orb_slam2_tpu_torch.ops import image as timage
from active_orb_slam2_tpu_torch.ops import matching as tmatch
from active_orb_slam2_tpu_torch.ops import orb as torb
from active_orb_slam2_tpu_torch.ops import patches as tpatches

torch.set_num_threads(1)

CAM = dict(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8, width=320,
           height=240)
J_CFG = JOrbConfig(n_features=512, n_levels=4)
T_CFG = OrbConfig(n_features=512, n_levels=4)


def bits(desc):
    """[K, 8] int32 / uint32 descriptors -> [K, 256] bits."""
    d = np.ascontiguousarray(np.asarray(desc)).view(np.uint32)
    return np.unpackbits(d.view(np.uint8), axis=-1)


@pytest.fixture(scope="module")
def frame0():
    """Frame 0 of the orbit as the System feeds it (uint8 gray)."""
    g, _, _ = next(tsyn.make_sequence(
        1, CameraParams(**CAM), world=tsyn.default_world(),
        trajectory=tsyn.orbit_trajectory(1, step_deg=2.0)))
    return np.clip(g, 0, 255).astype(np.uint8).astype(np.float32)


@pytest.fixture(scope="module")
def level1(frame0):
    """Level 1 of the pyramid (fractional pixels: bf16 rounding live),
    with its detected keypoints, from the JAX package."""
    h, w = jorb._level_sizes(240, 320, J_CFG)[1]
    img = jimage.resize_bilinear(jnp.asarray(frame0), h, w)
    score = jorb._threshold_fallback(
        jfast.nms3x3(jfast.fast_score_map(img)), J_CFG)
    ys, xs, resp = jorb._detect_level(
        score, jorb._features_per_level(J_CFG)[1], J_CFG)
    padded = jimage.pad_image(img, J_CFG.pad)
    return (np.array(img), np.array(padded), np.array(ys), np.array(xs),
            np.array(resp), np.array(score))


def test_synthetic_frames_match_jax():
    small = {**CAM, "width": 64, "height": 48}
    for (gj, dj, tj), (gt, dt, tt) in zip(
            jsyn.make_sequence(2, JCam(**small)),
            tsyn.make_sequence(2, CameraParams(**small))):
        np.testing.assert_array_equal(gj, gt)
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(tj, tt)


def test_constant_tables_match_jax():
    np.testing.assert_array_equal(torb.descriptor_pattern(1234),
                                  jorb.descriptor_pattern(1234))
    np.testing.assert_array_equal(torb.moment_matrix(), jorb._moment_matrix())
    np.testing.assert_array_equal(torb.blur_matrix(), jorb._blur_matrices())
    np.testing.assert_array_equal(timage.gaussian_kernel1d(7, 2.0),
                                  jimage._gaussian_kernel1d(7, 2.0))
    # the flat-index table selects exactly the one-hot taps
    S = jorb._tap_matrix()                                  # [30, 961, 512]
    np.testing.assert_array_equal(torb.tap_table(), S.argmax(axis=1))
    assert (S.sum(axis=1) == 1).all()
    for n_in, n_out in [(240, 200), (320, 267), (480, 134)]:
        np.testing.assert_array_equal(timage.resize_weights(n_in, n_out),
                                      jimage._resize_weights(n_in, n_out))
    assert torb.level_sizes(480, 640, T_CFG) == jorb._level_sizes(
        480, 640, J_CFG)
    assert torb.features_per_level(OrbConfig()) == jorb._features_per_level(
        JOrbConfig())


def test_fast_and_nms_level0_exact(frame0):
    s_t = tfast.nms3x3(tfast.fast_score_map(torch.from_numpy(frame0)))
    s_j = jfast.nms3x3(jfast.fast_score_map(jnp.asarray(frame0)))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (s_t.numpy() > 0).sum() > 500


def test_pyramid_level_and_detection_match_jax(frame0, level1):
    img, padded, ys, xs, resp, score = level1
    h, w = img.shape
    t_img = timage.resize_bilinear(torch.from_numpy(frame0), h, w)
    np.testing.assert_allclose(t_img.numpy(), img, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        timage.pad_image(torch.from_numpy(img), 24).numpy(), padded)
    # on identical level images, FAST + fallback + distribution agree
    t_score = torb.threshold_fallback(
        tfast.nms3x3(tfast.fast_score_map(torch.from_numpy(img))), T_CFG)
    np.testing.assert_array_equal(t_score.numpy(), score)
    t_ys, t_xs, t_resp = torb.detect_level(t_score, len(ys), T_CFG)
    np.testing.assert_array_equal(t_ys.numpy(), ys)
    np.testing.assert_array_equal(t_xs.numpy(), xs)
    np.testing.assert_array_equal(t_resp.numpy(), resp)


def test_extract_patches_bit_exact(level1):
    _, padded, ys, xs, _, _ = level1
    rng = np.random.default_rng(3)
    # detected keypoints plus border and out-of-range ones (clipped)
    ys = np.concatenate([ys[:40], rng.integers(-30, padded.shape[0], 24),
                         [0, padded.shape[0]]]).astype(np.int32)
    xs = np.concatenate([xs[:40], rng.integers(-30, padded.shape[1], 24),
                         [padded.shape[1], 0]]).astype(np.int32)
    p_t = tpatches.extract_patches(torch.from_numpy(padded),
                                   torch.from_numpy(ys), torch.from_numpy(xs),
                                   24).numpy()
    p_j = np.asarray(jpatches.extract_patches(jnp.asarray(padded),
                                              jnp.asarray(ys),
                                              jnp.asarray(xs), 24))
    np.testing.assert_array_equal(p_t, p_j)
    # and numpy slicing of the bf16-rounded image
    img_bf = np.asarray(jnp.asarray(padded).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    hp, wp = padded.shape
    for k in range(len(ys)):
        y0 = int(np.clip(ys[k] + 24 - 18, 0, hp - 40))
        x0 = int(np.clip(xs[k] + 24 - 18, 0, wp - 40))
        np.testing.assert_array_equal(p_t[k], img_bf[y0:y0 + 40, x0:x0 + 40])


def test_keypoint_stage_matches_jax(level1):
    _, padded, ys, xs, _, _ = level1
    ang_j, desc_j = jorb._keypoint_stage(jnp.asarray(padded), jnp.asarray(ys),
                                         jnp.asarray(xs), 24)
    ang_t, desc_t = torb.keypoint_stage(torch.from_numpy(padded),
                                        torch.from_numpy(ys),
                                        torch.from_numpy(xs), 24)
    d = np.remainder(ang_t.numpy() - np.asarray(ang_j) + np.pi,
                     2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-4, np.abs(d).max()
    agree = (bits(desc_t) == bits(desc_j)).mean()
    assert agree >= 0.999, agree


def test_build_extractor_matches_jax(frame0):
    f_j = jorb.build_extractor(J_CFG, 240, 320)(jnp.asarray(frame0))
    f_t = torb.build_extractor(T_CFG, 240, 320)(torch.from_numpy(frame0))
    assert f_t.uv.shape == (512, 2) and f_t.desc.dtype == torch.int32
    vj = np.asarray(f_j.valid)
    assert vj.sum() > 400
    same = ((f_t.uv.numpy() == np.asarray(f_j.uv)).all(1)
            & (f_t.level.numpy() == np.asarray(f_j.level))
            & (f_t.valid.numpy() == vj))
    assert same[vj].mean() >= 0.98, same[vj].mean()
    sel = same & vj
    agree = (bits(f_t.desc)[sel] == bits(f_j.desc)[sel]).mean()
    assert agree >= 0.999, agree
    np.testing.assert_allclose(f_t.response.numpy()[sel],
                               np.asarray(f_j.response)[sel])


def test_extractor_flat_image():
    """Flat image -> no corners -> all slots invalid, no NaNs (the empty
    slots still go through the keypoint stage)."""
    cfg = OrbConfig(n_features=256, n_levels=4)
    f = torb.build_extractor(cfg, 120, 160)(torch.full((120, 160), 128.0))
    assert int(f.valid.sum()) == 0
    assert torch.isfinite(f.uv).all() and torch.isfinite(f.angle).all()


def test_matching_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, (48, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    b[:8] = a[:8]                       # exact duplicates -> ties
    b[8:16] = a[:8] ^ 1
    va, vb = rng.random(48) < 0.9, rng.random(64) < 0.9
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(
        b.view(np.int32))
    d_t = tmatch.hamming_matrix(ta, tb, torch.from_numpy(va),
                                torch.from_numpy(vb))
    d_j = jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(va), jnp.asarray(vb))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    idx_t, dist_t = tmatch.match_mutual(d_t, max_dist=120.0, ratio=0.9)
    idx_j, dist_j = jmatch.match_mutual(d_j, max_dist=120.0, ratio=0.9)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))
    # integer-valued distance matrix with many ties
    d = rng.integers(0, 6, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tmatch.match_mutual(torch.from_numpy(d), max_dist=3.0)[0].numpy(),
        np.asarray(jmatch.match_mutual(jnp.asarray(d), max_dist=3.0)[0]))

    proj = rng.uniform(0, 100, (48, 2)).astype(np.float32)
    feats = rng.uniform(0, 100, (64, 2)).astype(np.float32)
    radii = rng.uniform(5, 40, 48).astype(np.float32)
    plv = rng.integers(0, 4, 48).astype(np.int32)
    flv = rng.integers(0, 4, 64).astype(np.int32)
    out_t = tmatch.search_by_projection(
        torch.from_numpy(proj), torch.from_numpy(radii), torch.from_numpy(plv),
        ta, torch.from_numpy(va), torch.from_numpy(feats),
        torch.from_numpy(flv), tb, torch.from_numpy(vb), max_dist=128.0)
    out_j = jmatch.search_by_projection(proj, radii, plv, jnp.asarray(a), va,
                                        feats, flv, jnp.asarray(b), vb,
                                        max_dist=128.0)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))

    m = 100
    aq = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    at = (aq - 0.3).astype(np.float32)
    at[:10] = rng.uniform(0, 2 * np.pi, 10)
    idx = np.arange(m, dtype=np.int32)
    idx[::7] = -1
    np.testing.assert_array_equal(
        tmatch.rotation_consistency_mask(torch.from_numpy(aq),
                                         torch.from_numpy(at),
                                         torch.from_numpy(idx)).numpy(),
        np.asarray(jmatch.rotation_consistency_mask(aq, at, idx)))
