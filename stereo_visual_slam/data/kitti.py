"""KITTI odometry dataset reader.

Replaces VO::read_img (visual_odometry.cpp:37-68): loads grayscale stereo
pairs by 6-digit zero-padded id from `image_0/` (left) and `image_1/`
(right) under the sequence directory. Also parses `calib.txt` (P0/P1
projection matrices -> fx, fy, cx, cy, baseline) and, when available, the
odometry ground-truth pose file for evaluation.

Layout expected (standard KITTI odometry):
    <root>/sequences/<seq>/image_0/000000.png ...
    <root>/sequences/<seq>/image_1/000000.png ...
    <root>/sequences/<seq>/calib.txt
    <root>/poses/<seq>.txt                      (optional ground truth)

or a bare sequence directory containing image_0/, image_1/, calib.txt
(matching the reference's `/dataset` rosparam pointing straight at the
sequence, kitti_param.yaml:2).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from stereo_visual_slam.utils.config import CameraConfig, Config


def _imread_gray(path: str) -> np.ndarray:
    from stereo_visual_slam.utils import native

    if native.available():
        return native.read_image_gray(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


@dataclasses.dataclass
class KittiSequence:
    seq_dir: str
    n_frames: int
    camera: CameraConfig
    gt_T_c_w: Optional[np.ndarray] = None   # (F, 4, 4) world->camera

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        name = f"{i:06d}.png"
        left = _imread_gray(os.path.join(self.seq_dir, "image_0", name))
        right = _imread_gray(os.path.join(self.seq_dir, "image_1", name))
        return left, right

    def frames(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Stream (i, left, right). Uses the native multithreaded prefetcher
        (utils/native.py) when available so image decode overlaps the
        consumer's device compute; falls back to synchronous reads."""
        from stereo_visual_slam.utils import native

        if native.available() and self.n_frames > 0:
            h, w = self.frame_hw()
            with native.StereoPrefetcher(
                os.path.join(self.seq_dir, "image_0"),
                os.path.join(self.seq_dir, "image_1"),
                count=self.n_frames,
                hw=(h, w),
            ) as pf:
                yield from pf
            return
        for i in range(self.n_frames):
            left, right = self.frame(i)
            yield i, left, right

    def frame_hw(self) -> Tuple[int, int]:
        left, _ = self.frame(0)
        return left.shape


def parse_calib(calib_path: str) -> CameraConfig:
    """fx/fy/cx/cy from P0; baseline from P1's -fx*b entry."""
    P = {}
    with open(calib_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0].rstrip(":")
            if key in ("P0", "P1"):
                P[key] = np.array([float(x) for x in parts[1:]]).reshape(3, 4)
    if "P0" not in P or "P1" not in P:
        raise ValueError(f"calib file missing P0/P1: {calib_path}")
    fx = float(P["P0"][0, 0])
    fy = float(P["P0"][1, 1])
    cx = float(P["P0"][0, 2])
    cy = float(P["P0"][1, 2])
    baseline = float(-P["P1"][0, 3] / fx)
    return CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline)


def load_gt_poses(path: str) -> np.ndarray:
    """KITTI pose file (rows of 3x4 T_w_c) -> (F, 4, 4) T_c_w."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    F = rows.shape[0]
    T_w_c = np.tile(np.eye(4), (F, 1, 1))
    T_w_c[:, :3, :4] = rows
    return np.linalg.inv(T_w_c)


def open_sequence(
    root: str, sequence: Optional[str] = None
) -> KittiSequence:
    """Open a KITTI odometry sequence. `root` may be the dataset root (then
    pass `sequence`, e.g. '00') or a sequence directory itself."""
    if sequence is not None:
        seq_dir = os.path.join(root, "sequences", sequence)
        gt_path = os.path.join(root, "poses", f"{sequence}.txt")
    else:
        seq_dir = root
        gt_path = None

    left_dir = os.path.join(seq_dir, "image_0")
    if not os.path.isdir(left_dir):
        raise FileNotFoundError(f"no image_0/ under {seq_dir}")
    n = len([f for f in os.listdir(left_dir) if f.endswith(".png")])

    calib_path = os.path.join(seq_dir, "calib.txt")
    camera = parse_calib(calib_path) if os.path.exists(calib_path) else CameraConfig()

    gt = None
    if gt_path and os.path.exists(gt_path):
        gt = load_gt_poses(gt_path)

    return KittiSequence(seq_dir=seq_dir, n_frames=n, camera=camera, gt_T_c_w=gt)


def config_for(seq: KittiSequence, base: Optional[Config] = None) -> Config:
    """Build a pipeline Config with this sequence's intrinsics and image
    size."""
    base = base or Config()
    left, _ = seq.frame(0)
    return base.replace(camera=seq.camera, image_hw=left.shape)
