"""Typed configuration, loadable from reference-style YAML settings.

Port of ``active_orb_slam2_tpu/config.py``: the same four dataclasses
with the same fields and defaults, and the same YAML readers.  It is
declared again because the JAX module imports ``CameraParams`` from a
module that imports jax.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from active_orb_slam2_tpu_torch.geometry.projection import CameraParams


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORBextractor settings."""
    n_features: int = 1024
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 16             # spatial-distribution cell (px)
    cell_top_k: int = 4             # candidates kept per cell pre-topk
    patch_radius: int = 15          # IC_Angle / rBRIEF patch
    pad: int = 24                   # per-level border pad (covers rotated BRIEF)


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Thresholds from Tracking/ORBmatcher."""
    th_depth: float = 40.0              # close/far stereo point cutoff (x bf/fx)
    depth_map_factor: float = 5000.0    # TUM depth scaling
    nn_ratio_motion: float = 0.9        # SearchByProjection ratio (motion model)
    nn_ratio_local: float = 0.8
    th_low: int = 50                    # ORBmatcher::TH_LOW (Hamming)
    th_high: int = 100                  # ORBmatcher::TH_HIGH
    min_matches_motion: int = 20
    min_inliers_track: int = 10
    min_inliers_local: int = 30
    max_local_keyframes: int = 80       # UpdateLocalKeyFrames cap
    kf_min_interval: int = 0            # min frames between KFs
    kf_max_interval: int = 30           # mMaxFrames ~ fps
    kf_ref_ratio: float = 0.9           # NeedNewKeyFrame tracked/ref ratio


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed arena capacities."""
    max_keyframes: int = 512
    max_points: int = 65536
    covis_min_weight: int = 15          # KeyFrame::UpdateConnections edge th
    covis_strong_weight: int = 100      # essential-graph strong edges
    local_ba_keyframes: int = 16        # local BA window (covis KFs)
    local_ba_points: int = 4096


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraParams = CameraParams(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
        width=640, height=480)
    orb: OrbConfig = OrbConfig()
    tracking: TrackingConfig = TrackingConfig()
    map: MapConfig = MapConfig()
    fps: float = 30.0
    sensor: str = "rgbd"                # "mono" | "stereo" | "rgbd"
    distortion: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # k1 k2 p1 p2 k3


def _parse_opencv_yaml(text: str) -> dict:
    """Minimal parser for cv::FileStorage YAML ("%YAML:1.0"): flat
    ``Key.Sub: value`` scalars plus opencv-matrix blocks."""
    out = {}
    text = re.sub(r"%YAML:[\d.]+", "", text)
    mat_re = re.compile(
        r"^(\S+):\s*!!opencv-matrix\s*\n\s*rows:\s*(\d+)\s*\n\s*cols:\s*(\d+)"
        r"\s*\n\s*dt:\s*\S+\s*\n\s*data:\s*\[([^\]]*)\]",
        re.M)
    for m in mat_re.finditer(text):
        vals = [float(v) for v in m.group(4).replace("\n", " ").split(",")]
        out[m.group(1)] = {
            "rows": int(m.group(2)), "cols": int(m.group(3)), "data": vals}
    text = mat_re.sub("", text)
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line or ":" not in line:
            continue
        key, _, val = line.partition(":")
        val = val.strip().strip('"')
        if not val:
            continue
        try:
            out[key.strip()] = float(val) if "." in val or "e" in val.lower() \
                else int(val)
        except ValueError:
            out[key.strip()] = val
    return out


def load_settings(path: str, sensor: str = "rgbd",
                  width: Optional[int] = None,
                  height: Optional[int] = None) -> SlamConfig:
    """Load a reference-format YAML settings file into a SlamConfig."""
    with open(path) as f:
        d = _parse_opencv_yaml(f.read())
    cam = CameraParams(
        fx=float(d["Camera.fx"]), fy=float(d["Camera.fy"]),
        cx=float(d["Camera.cx"]), cy=float(d["Camera.cy"]),
        bf=float(d.get("Camera.bf", 0.0)),
        width=int(d.get("Camera.width", width or 640)),
        height=int(d.get("Camera.height", height or 480)))
    orb = OrbConfig(
        n_features=int(d.get("ORBextractor.nFeatures", 1024)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=float(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=float(d.get("ORBextractor.minThFAST", 7)))
    bl = cam.bf / cam.fx if cam.fx else 0.0
    tracking = TrackingConfig(
        th_depth=float(d.get("ThDepth", 40.0)) * bl if bl else 40.0,
        depth_map_factor=float(d.get("DepthMapFactor", 5000.0)))
    dist = tuple(float(d.get(f"Camera.{k}", 0.0))
                 for k in ("k1", "k2", "p1", "p2", "k3"))
    if any(v != 0.0 for v in dist):
        from active_orb_slam2_tpu_torch.ops.undistort import (
            compute_image_bounds)
        x0, x1, y0, y1 = compute_image_bounds(cam, dist)
        cam = cam._replace(min_x=x0, max_x=x1, min_y=y0, max_y=y1)
    return SlamConfig(camera=cam, orb=orb, tracking=tracking,
                      fps=float(d.get("Camera.fps", 30.0)),
                      sensor=sensor, distortion=dist)


def load_rectification(path: str):
    """Read the EuRoC-style ``LEFT/RIGHT.{K,D,R,P}`` rectification blocks.

    Returns ``(K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r, width, height)``,
    or ``None`` if the file carries no rectification blocks.
    """
    import numpy as np
    with open(path) as f:
        d = _parse_opencv_yaml(f.read())
    if "LEFT.K" not in d:
        return None

    def mat(key):
        blk = d[key]
        return np.array(blk["data"], np.float64).reshape(
            blk["rows"], blk["cols"])

    out = []
    for side in ("LEFT", "RIGHT"):
        out += [mat(f"{side}.K"), mat(f"{side}.D").ravel(),
                mat(f"{side}.R"), mat(f"{side}.P")]
    width = int(d.get("LEFT.width", d.get("Camera.width", 752)))
    height = int(d.get("LEFT.height", d.get("Camera.height", 480)))
    return tuple(out) + (width, height)
