"""Headless visualization: a snapshot of the map and trajectory as numpy
arrays, and matplotlib plots written to files.

Port of ``active_orb_slam2_tpu/utils/viz.py``, the stand-in for the
reference's Pangolin viewer (``Viewer``, ``FrameDrawer``,
``MapDrawer``): everything the viewer would draw, with no GUI thread.
matplotlib is imported by the plotting calls only, so the package
imports without it.
"""

import numpy as np
import torch

from active_orb_slam2_tpu_torch.io.trajectory import camera_centers


def map_snapshot(slam) -> dict:
    """Everything the reference viewer draws, as numpy arrays: each map
    tensor is read from the device once."""
    ts, poses = slam.frame_trajectory()
    m = slam.map
    pt_valid = m.pt_valid.cpu().numpy()
    kf_valid = m.kf_valid.cpu().numpy()
    kf_pose = m.kf_pose.cpu().numpy()[kf_valid]
    return {
        "points": m.pt_xyz.cpu().numpy()[pt_valid],
        "keyframe_poses": kf_pose,
        "keyframe_centers": camera_centers(kf_pose) if kf_valid.any()
        else np.zeros((0, 3)),
        "trajectory": camera_centers(poses) if len(poses)
        else np.zeros((0, 3)),
        "timestamps": ts,
        "n_points": int(pt_valid.sum()),
        "n_keyframes": int(kf_valid.sum()),
        "state": slam.state,
        "n_loops_closed": slam.n_loops_closed,
    }


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_map(slam, path: str, gt_centers=None):
    """Top-down (x-z) map and trajectory plot to ``path`` (PNG)."""
    plt = _pyplot()
    snap = map_snapshot(slam)
    fig, ax = plt.subplots(figsize=(7, 7))
    p = snap["points"]
    if len(p):
        ax.scatter(p[:, 0], p[:, 2], s=1, c="#999999", label="map points")
    tr = snap["trajectory"]
    if len(tr):
        ax.plot(tr[:, 0], tr[:, 2], "-", c="#d4502e", lw=1.5,
                label="estimate")
    kc = snap["keyframe_centers"]
    if len(kc):
        ax.scatter(kc[:, 0], kc[:, 2], s=14, c="#2e6fd4", marker="s",
                   label="keyframes")
    if gt_centers is not None and len(gt_centers):
        g = np.asarray(gt_centers)
        ax.plot(g[:, 0], g[:, 2], "--", c="#3a3a3a", lw=1.0,
                label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(f"{snap['n_keyframes']} KFs, {snap['n_points']} points, "
                 f"{snap['n_loops_closed']} loops")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_occupancy(grid, path: str):
    """Occupancy-grid image to ``path`` (PNG): unknown grey, free white,
    occupied black.  ``grid`` is a numpy array or a tensor."""
    plt = _pyplot()
    g = torch.as_tensor(grid).cpu().numpy().astype(np.int16)
    img = np.full(g.shape, 0.6)
    img[g == 0] = 1.0
    img[g == 100] = 0.0
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(img, cmap="gray", origin="lower", vmin=0, vmax=1)
    ax.set_title("occupancy (x-z)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
