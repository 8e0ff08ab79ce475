"""``tests/test_noise_robustness.py`` on the port: 30 frames of the orbit
with photometric noise (sigma 3) and Kinect-level depth noise, ATE
(rigid) below 0.04 m; the JAX package's ATE on the same frames is
printed beside the port's.  Slow, as the JAX package's is."""

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.io.trajectory import camera_centers as jcenters
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models import system as tsys
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
from tests.test_torch_tracking import configs

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

N = 30


def test_noisy_rgbd_ate_bound():
    jc, tc = configs()      # tests/test_noise_robustness.py's CFG
    frames = list(jsyn.make_sequence(
        N, jc.camera, world=jsyn.default_world(),
        trajectory=jsyn.orbit_trajectory(N, step_deg=2.0),
        photo_noise=3.0, depth_noise=1.0))
    gt = np.stack([Twc[:3, 3] for _, _, Twc in frames])
    ates = {}
    for name, slam, centres, ok in (
            ("port", tsys.System(tc, device="cpu"), camera_centers, tsys.OK),
            ("jax", jsys.System(jc, pipeline_depth=0, retire_batch=1),
             jcenters, jsys.OK)):
        for i, (g, d, _) in enumerate(frames):
            slam.track_rgbd(g, d, i / 30.0)
        assert slam.state == ok, name
        _, poses = slam.frame_trajectory()
        ates[name] = umeyama_alignment(np.asarray(centres(poses)), gt,
                                       fix_scale=True)[4]
    print(f"noisy RGB-D ATE over {N} frames: port {ates['port']:.5f} m, "
          f"JAX {ates['jax']:.5f} m", flush=True)
    assert ates["port"] < 0.04, f"noisy ATE {ates['port']:.4f} m"
