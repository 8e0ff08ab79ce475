"""Build the benchmark's fixed ORB vocabulary, ``benchmark/data/
orb_vocab_k10_l4.txt`` (DBoW2 text format, k = 10, L = 4: 10,000 words).

    python3 benchmark/build_vocabulary.py [--out PATH] [--device cpu]

As ``ORBvoc.txt`` was trained on images unrelated to any sequence it is
used on, the descriptors come from worlds of other seeds than the
benchmark's: box worlds with 8 obstacles and texture seeds 1 to 10, each
seen from 40 poses drawn at random in the room (position, heading and
pitch) by TUM fr1's camera without its lens, about 400,000 descriptors,
some 40 to a word.  They are extracted by the program's frame pipeline
and clustered by its ``train_vocabulary``; ``save_text_vocabulary``
writes the file.  The file is committed; the benchmark's runs only load
it.
"""

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.reference import settings  # noqa: E402
from benchmark.traffic import world as W  # noqa: E402

WORLD_SEEDS = range(1, 11)
POSES_PER_WORLD = 40
POSE_SEED = 7


def random_pose(rng):
    """Camera-to-world 4x4 float32: a point of the room up to 3 m from
    its axis, any heading, a pitch within 0.4 rad."""
    r, th = rng.uniform(0.5, 3.0), rng.uniform(0.0, 2.0 * np.pi)
    pos = np.array([r * np.sin(th), rng.uniform(-1.0, 1.0),
                    -r * np.cos(th)], np.float32)
    yaw, pitch = rng.uniform(0.0, 2.0 * np.pi), rng.uniform(-0.4, 0.4)
    fwd = np.array([np.cos(yaw) * np.cos(pitch), np.sin(pitch),
                    np.sin(yaw) * np.cos(pitch)], np.float32)
    right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
    right /= np.linalg.norm(right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = (right, np.cross(fwd, right),
                                              fwd, pos)
    return T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "data",
                                                  "orb_vocab_k10_l4.txt"))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    from active_orb_slam2_tpu_torch.config import OrbConfig, SlamConfig
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.models.frame import build_frame_pipeline
    from active_orb_slam2_tpu_torch.models.vocabulary import (
        save_text_vocabulary, train_vocabulary)
    dev = torch.device(args.device)
    cam, orb, _ = settings.load(os.path.join(HERE, "configs",
                                             "tum_fr1_rgbd.yaml"), 640, 480)
    cfg = SlamConfig(camera=CameraParams(cam.fx, cam.fy, cam.cx, cam.cy,
                                         cam.bf, cam.width, cam.height),
                     orb=OrbConfig(n_features=orb.n_features))
    make_rgbd, _ = build_frame_pipeline(cfg)
    rng = np.random.default_rng(POSE_SEED)
    descs = []
    for seed in WORLD_SEEDS:
        world = W.box_world(8, seed)
        for _ in range(POSES_PER_WORLD):
            twc = torch.from_numpy(random_pose(rng)[None]).to(dev)
            g, d = W.render(world, cam, twc, 2)
            f, _ = make_rgbd(W.to_uint8(g[0]), d[0])
            descs.append(f.desc[f.valid].cpu().numpy())
    corpus = np.concatenate(descs)
    print(f"{len(corpus)} descriptors from {len(descs)} frames", flush=True)
    voc = train_vocabulary(corpus.view(np.uint32), k=10, depth=4)
    save_text_vocabulary(voc, args.out)
    print(f"wrote {args.out}: {voc.n_words} words")


if __name__ == "__main__":
    main()
