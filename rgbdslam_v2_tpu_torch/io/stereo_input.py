"""Stereo input: rectified left/right image pairs -> RGB-D frames.

Port of ``rgbdslam_v2_tpu/io/stereo_input.py`` (``StereoDataset``,
``save_as_stereo_dataset``, ``render_stereo_sequence``; the reference's
stereoCallback, src/openni_listener.cpp:559-598). A dataset is a directory
with ``left/`` and ``right/`` image directories whose files pair by name;
a file's stamp is its stem when that is a number (TUM's naming), else its
index / 30 s; ``groundtruth.txt`` (TUM format) is optional.

The JAX package reads and writes the images with cv2, which the card's
machine does not have; here they go through the port's PNG codec
(``io/png.py``), and the grey images are what cv2 reads from those files:
libpng's RGB-to-grey at cv2's weights 0.299 / 0.587, in 15-bit fixed point
and truncated, a grey pixel kept as it is (``png_gray``).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from .png import read_png, write_png


def png_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 -> (H, W) u8 as libpng's png_set_rgb_to_gray(0.299,
    0.587) converts a PNG's rows (cv2.IMREAD_GRAYSCALE): coefficients
    9797, 19234 and 3737 over 2^15, truncated; where R = G = B the pixel
    keeps its value."""
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    gray = ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    return np.where((r == g) & (g == b), rgb[..., 0], gray)


class StereoDataset:
    def __init__(self, pairs: List[Tuple[float, Path, Path]]):
        self.pairs = pairs

    @classmethod
    def open(cls, root) -> "StereoDataset":
        root = Path(root)
        lefts = sorted((root / "left").iterdir())
        rights = {p.name: p for p in (root / "right").iterdir()}
        pairs = []
        for k, lp in enumerate(lefts):
            rp = rights.get(lp.name)
            if rp is None:
                continue
            try:
                ts = float(lp.stem)
            except ValueError:
                ts = k / 30.0
            pairs.append((ts, lp, rp))
        if not pairs:
            raise FileNotFoundError(f"no left/right image pairs under {root}")
        return cls(pairs)

    def __len__(self):
        return len(self.pairs)

    def load(self, i: int):
        """-> (stamp, left rgb u8 (H, W, 3), left grey float32 (H, W),
        right grey float32), the greys in [0, 1]."""
        ts, lp, rp = self.pairs[i]
        rgb = _rgb(read_png(lp))
        gl = png_gray(rgb).astype(np.float32)
        gr = png_gray(_rgb(read_png(rp))).astype(np.float32)
        return ts, rgb, gl / 255.0, gr / 255.0


def _rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError(f"a stereo image is 8-bit RGB, not {img.dtype} {img.shape}")
    return img


def save_as_stereo_dataset(out, poses, lefts, rights, stamps=None) -> None:
    """Write left/ and right/ PNGs and groundtruth.txt: the stereo
    counterpart of io.synthetic.save_as_tum_dataset. Float images in [0, 1]
    are written as u8 (x 255, truncated), grey ones as RGB."""
    from ..core.se3 import pose_to_tum

    out = Path(out)
    (out / "left").mkdir(parents=True, exist_ok=True)
    (out / "right").mkdir(parents=True, exist_ok=True)
    n = len(lefts)
    stamps = stamps if stamps is not None else [k / 30.0 for k in range(n)]
    gt_lines = []
    for k in range(n):
        name = f"{stamps[k]:.6f}.png"
        for sub, img in (("left", lefts[k]), ("right", rights[k])):
            a = np.asarray(img)
            if a.dtype.kind == "f":
                a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
            if a.ndim == 2:
                a = np.repeat(a[..., None], 3, axis=-1)
            write_png(out / sub / name, a)
        t, q = pose_to_tum(torch.tensor(np.asarray(poses[k], np.float32)))
        gt_lines.append(f"{stamps[k]:.6f} " + " ".join(f"{v:.6f}" for v in t.tolist())
                        + " " + " ".join(f"{v:.6f}" for v in q.tolist()) + "\n")
    (out / "groundtruth.txt").write_text("".join(gt_lines))


def render_stereo_sequence(world, n_frames: int, baseline: float, seed: int = 1, device=None):
    """A rectified synthetic stereo sequence rendered on `device` (None:
    the CUDA card): the right camera is the left pose moved +baseline along
    the camera's x axis (exact rectification). Returns (poses, lefts u8,
    rights u8, left depths) as host arrays."""
    from .synthetic import render_sequence

    poses = world.orbit_trajectory(n_frames, seed=seed, device="cpu").numpy()
    right = poses.copy()
    right[:, :3, 3] += poses[:, :3, 0] * baseline
    _, lefts, depths = render_sequence(world, n_frames, trajectory=poses, device=device)
    _, rights, _ = render_sequence(world, n_frames, trajectory=right, device=device)
    return poses, lefts, rights, depths
