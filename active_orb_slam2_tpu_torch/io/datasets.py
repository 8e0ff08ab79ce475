"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Numpy copy of ``active_orb_slam2_tpu/io/datasets.py``: TUM ``rgb.txt``
/ ``depth.txt`` with nearest-timestamp association (the benchmark's
``associate.py``), KITTI ``times.txt`` with ``image_0`` / ``image_1``,
EuRoC ``mav0/cam0`` / ``cam1`` with optional stereo rectification from
the settings' ``LEFT`` / ``RIGHT`` blocks.  Images decode through the
port's native binding (``io/native.py``), or PIL.
"""

import os

import numpy as np


def _load_gray(path: str) -> np.ndarray:
    from active_orb_slam2_tpu_torch.io.native import decode_gray
    img = decode_gray(path)
    if img.dtype == np.uint16:            # 16-bit source used as gray
        return (img >> 8).astype(np.uint8)
    return img


def _load_depth_png(path: str) -> np.ndarray:
    from active_orb_slam2_tpu_torch.io.native import decode_gray
    return decode_gray(path).astype(np.uint16)


def _read_stamped_list(path: str):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def associate(a, b, max_dt: float = 0.02):
    """Nearest-timestamp association (TUM associate.py [U])."""
    pairs = []
    bi = 0
    for ta, pa in a:
        # advance b pointer to the closest timestamp
        while bi + 1 < len(b) and abs(b[bi + 1][0] - ta) <= abs(
                b[bi][0] - ta):
            bi += 1
        if abs(b[bi][0] - ta) <= max_dt:
            pairs.append((ta, pa, b[bi][1]))
    return pairs


class TumRgbdDataset:
    """TUM RGB-D sequence: yields (t, gray u8, depth u16[mm-ish])."""

    def __init__(self, root: str, depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        rgb = _read_stamped_list(os.path.join(root, "rgb.txt"))
        dep = _read_stamped_list(os.path.join(root, "depth.txt"))
        self.pairs = associate(rgb, dep)

    def __len__(self):
        return len(self.pairs)

    def __iter__(self):
        for t, rgb_p, dep_p in self.pairs:
            gray = _load_gray(os.path.join(self.root, rgb_p))
            dep_raw = _load_depth_png(os.path.join(self.root, dep_p))
            # store as uint16 millimetres for the narrow transfer path
            depth_mm = (dep_raw.astype(np.float32)
                        / self.depth_factor * 1000.0)
            yield t, gray, np.clip(depth_mm, 0, 65535).astype(np.uint16)

    def groundtruth(self):
        """[(t, [tx ty tz qx qy qz qw])] from groundtruth.txt."""
        path = os.path.join(self.root, "groundtruth.txt")
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = [float(x) for x in line.split()]
                out.append((v[0], np.array(v[1:8], np.float32)))
        return out


class KittiOdometryDataset:
    """KITTI odometry sequence: yields (t, left u8, right u8)."""

    def __init__(self, root: str, sequence: str):
        self.dir = os.path.join(root, "sequences", sequence)
        with open(os.path.join(self.dir, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left = sorted(os.listdir(os.path.join(self.dir, "image_0")))
        self.right = sorted(os.listdir(os.path.join(self.dir, "image_1")))

    def __len__(self):
        return len(self.times)

    def __iter__(self):
        for t, l, r in zip(self.times, self.left, self.right):
            yield (t,
                   _load_gray(os.path.join(self.dir, "image_0", l)),
                   _load_gray(os.path.join(self.dir, "image_1", r)))


class EurocDataset:
    """EuRoC MAV: yields (t, cam0 u8, cam1 u8); optional rectification
    maps applied (from the settings YAML LEFT/RIGHT blocks)."""

    def __init__(self, root: str, rectify_maps=None):
        self.c0 = os.path.join(root, "mav0", "cam0", "data")
        self.c1 = os.path.join(root, "mav0", "cam1", "data")
        names = sorted(os.listdir(self.c0))
        self.frames = [(int(n.split(".")[0]) * 1e-9, n) for n in names]
        self.rectify_maps = rectify_maps

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        for t, n in self.frames:
            l = _load_gray(os.path.join(self.c0, n))
            r_path = os.path.join(self.c1, n)
            if not os.path.exists(r_path):
                continue
            r = _load_gray(r_path)
            if self.rectify_maps is not None:
                (mlx, mly), (mrx, mry) = self.rectify_maps
                l = remap_bilinear(l, mlx, mly)
                r = remap_bilinear(r, mrx, mry)
            yield t, l, r


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """cv2.remap replacement (used for EuRoC rectification)."""
    h, w = img.shape
    x0 = np.clip(np.floor(map_x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(map_y).astype(int), 0, h - 2)
    fx = np.clip(map_x - x0, 0, 1)
    fy = np.clip(map_y - y0, 0, 1)
    im = img.astype(np.float32)
    out = (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x0 + 1] * fx * (1 - fy)
           + im[y0 + 1, x0] * (1 - fx) * fy + im[y0 + 1, x0 + 1] * fx * fy)
    inb = ((map_x >= 0) & (map_x <= w - 1)
           & (map_y >= 0) & (map_y <= h - 1))
    return np.where(inb, out, 0).astype(np.uint8)


def stereo_rectify_maps(K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r,
                        width: int, height: int):
    """Build undistort+rectify maps from the EuRoC YAML matrices
    (cv::initUndistortRectifyMap replacement, radtan model)."""
    def one(K, D, R, P):
        ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
        # normalized rectified coords
        x = (xs - P[0, 2]) / P[0, 0]
        y = (ys - P[1, 2]) / P[1, 1]
        pts = np.stack([x, y, np.ones_like(x)], -1) @ np.linalg.inv(R).T
        x = pts[..., 0] / pts[..., 2]
        y = pts[..., 1] / pts[..., 2]
        # apply distortion (k1 k2 p1 p2 [k3])
        k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
        k3 = D[4] if len(D) > 4 else 0.0
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
        map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
        return map_x, map_y
    return one(K_l, D_l, R_l, P_l), one(K_r, D_r, R_r, P_r)
