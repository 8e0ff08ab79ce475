"""The port's ``utils/viz.py`` against the JAX package's, on the CPU: the
map snapshot of one arena carried into the port by
``models/convert.py::map_from_jax_numpy``, and the two plots.

Every array read from the map or the trajectory is exact.  The camera
centers are computed: by the JAX package in float32 on XLA, by the
port's ``io/trajectory.py::camera_centers`` in float64, so they agree to
float32 rounding (poses within 3 m: 1e-6 m)."""

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.config import MapConfig, OrbConfig
from active_orb_slam2_tpu.models.map_state import empty_map
from active_orb_slam2_tpu.utils import viz as jviz
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)

CENTER_ATOL = 1e-6


class Slam:
    """What the snapshot reads of a ``System``."""

    def __init__(self, m, traj, state=2, n_loops_closed=1):
        self.map, self._traj = m, traj
        self.state, self.n_loops_closed = state, n_loops_closed

    def frame_trajectory(self):
        return self._traj


def random_poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([q, rng.uniform(-3, 3, (n, 3))], 1).astype(
        np.float32)


def slams(filled: bool):
    """The same arena and trajectory as a JAX-package and a port stub:
    holes in the keyframes and points when ``filled``, else empty."""
    rng = np.random.default_rng(0)
    m = empty_map(MapConfig(max_keyframes=16, max_points=256),
                  OrbConfig(n_features=32))
    arrays = {f: np.asarray(v) for f, v in zip(m._fields, m)}
    traj = (np.zeros(0), np.zeros((0, 7)))
    if filled:
        arrays.update(
            kf_valid=rng.random(16) < 0.7, pt_valid=rng.random(256) < 0.6,
            kf_pose=random_poses(rng, 16),
            pt_xyz=rng.uniform(-4, 4, (256, 3)).astype(np.float32))
        traj = (np.arange(30) / 30.0, random_poses(rng, 30))
    jm = type(m)(**arrays)
    return (Slam(jm, traj), Slam(convert.map_from_jax_numpy(arrays), traj),
            arrays)


@pytest.mark.parametrize("filled", [True, False])
def test_map_snapshot_matches_jax(filled):
    jslam, tslam, _ = slams(filled)
    want, got = jviz.map_snapshot(jslam), tviz.map_snapshot(tslam)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in ("keyframe_centers", "trajectory"):
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=CENTER_ATOL,
                                       err_msg=k)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, k, strict=True)
        else:
            assert got[k] == v, k
    assert (got["n_points"] > 0) == filled


def test_plots_write_pngs(tmp_path):
    _, tslam, arrays = slams(True)
    gt = np.random.default_rng(1).uniform(-3, 3, (30, 3))
    tviz.plot_map(tslam, str(tmp_path / "map.png"), gt_centers=gt)
    grid = torch.from_numpy(np.random.default_rng(2).choice(
        np.array([-1, 0, 100], np.int8), (32, 32)))
    tviz.plot_occupancy(grid, str(tmp_path / "grid.png"))
    for name in ("map.png", "grid.png"):
        data = (tmp_path / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000, name
