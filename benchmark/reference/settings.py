"""ORB-SLAM2 settings files, read for the reference.

A copy of the OpenCV-YAML reader that the program also has, so that the
reference takes its camera and extractor settings from the settings
file itself and not from the program's configuration objects.
"""

import re
from typing import NamedTuple


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int
    height: int
    dist: tuple      # k1 k2 p1 p2 k3


class Orb(NamedTuple):
    n_features: int
    scale_factor: float
    n_levels: int
    ini_th_fast: float
    min_th_fast: float
    cell_size: int = 16
    cell_top_k: int = 4
    pad: int = 24


def parse_yaml(text: str) -> dict:
    """Flat ``Key.Sub: value`` scalars of a cv::FileStorage YAML file."""
    out = {}
    text = re.sub(r"%YAML:[\d.]+", "", text)
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


def load(path: str, width: int, height: int):
    """(Camera, Orb, fps) of a settings file; the image size is the
    data's, as ORB-SLAM2 takes it from the images."""
    with open(path) as f:
        d = parse_yaml(f.read())
    dist = tuple(float(d.get(f"Camera.{k}", 0.0))
                 for k in ("k1", "k2", "p1", "p2", "k3"))
    cam = Camera(fx=float(d["Camera.fx"]), fy=float(d["Camera.fy"]),
                 cx=float(d["Camera.cx"]), cy=float(d["Camera.cy"]),
                 bf=float(d.get("Camera.bf", 0.0)), width=int(width),
                 height=int(height), dist=dist)
    orb = Orb(n_features=int(d["ORBextractor.nFeatures"]),
              scale_factor=float(d["ORBextractor.scaleFactor"]),
              n_levels=int(d["ORBextractor.nLevels"]),
              ini_th_fast=float(d["ORBextractor.iniThFAST"]),
              min_th_fast=float(d["ORBextractor.minThFAST"]))
    return cam, orb, float(d["Camera.fps"])
