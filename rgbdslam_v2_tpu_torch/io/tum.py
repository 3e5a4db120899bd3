"""TUM RGB-D dataset and trajectory I/O.

Port of ``rgbdslam_v2_tpu/io/tum.py``: ``_read_file_list``, ``associate``
(greedy closest-pair timestamp association), ``TumDataset`` (``open``,
``__len__``, ``timestamps``, ``load``), ``read_trajectory_file`` and
``rows_to_poses`` (numpy), and ``write_trajectory`` (one "stamp tx ty tz qx
qy qz qw" line per pose); and of ``io/native_loader.NativeTumLoader`` as
:class:`TumLoader`. Images decode through the port's own PNG codec
(``io/png.py``): ``load`` returns RGB directly (cv2 reads BGR, which the
JAX package reverses) and depth as ``d16.astype(float32) / 5000``, the
JAX package's values bit for bit.

:class:`TumLoader` decodes ahead of its consumer on ``LOADER_THREADS``
threads (inflate and the C unfilter release the GIL) into a ring of at
most ``LOADER_DEPTH`` frames, and hands them out in order. ``close()``
stops the pool; a decode error is raised to the consumer at that frame,
and the loader never restarts from frame 0 (a graph that already holds the
first frames would get them twice, JAX ``pipeline/slam.py:563-566``).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import se3
from .png import read_png

DEPTH_SCALE = 5000.0  # TUM depth PNGs: meters = u16 / 5000
# decode threads of TumLoader: a 640x480 frame (RGB + depth PNG) takes
# 16-21 ms on one host thread of an H100 machine (PERF.md §5; the more for
# libpng's adaptive filters), and 2 threads (the JAX native loader's
# default) capped the loader at 106 frames/s, below the ~140 fps the bench
# configuration runs at; 4 give 180-213 frames/s
LOADER_THREADS = 4
LOADER_DEPTH = 8  # frames TumLoader decodes ahead of its consumer


def _read_file_list(path) -> Dict[float, List[str]]:
    """A TUM index file: 'timestamp data...' lines, '#' comments."""
    out: Dict[float, List[str]] = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out[float(parts[0])] = parts[1:]
    return out


def associate(a_stamps: Sequence[float], b_stamps: Sequence[float],
              max_difference: float = 0.02, offset: float = 0.0) -> List[Tuple[int, int]]:
    """Greedy best-first pairing of two timestamp lists; index pairs."""
    bs = sorted(enumerate(b_stamps), key=lambda kv: kv[1])
    b_times = [t for _, t in bs]
    candidates = []
    for ia, ta in enumerate(a_stamps):
        lo = int(np.searchsorted(b_times, ta + offset - max_difference))
        hi = int(np.searchsorted(b_times, ta + offset + max_difference, side="right"))
        for k in range(lo, hi):
            ib, tb = bs[k]
            candidates.append((abs(ta + offset - tb), ia, ib))
    candidates.sort()
    used_a, used_b, out = set(), set(), []
    for _, ia, ib in candidates:
        if ia not in used_a and ib not in used_b:
            used_a.add(ia)
            used_b.add(ib)
            out.append((ia, ib))
    out.sort()
    return out


@dataclasses.dataclass
class TumDataset:
    """A TUM RGB-D sequence directory: rgb.txt, depth.txt, groundtruth.txt."""

    root: Path
    pairs: List[Tuple[float, str, float, str]]  # (rgb_stamp, rgb_file, d_stamp, d_file)
    groundtruth: Optional[np.ndarray]  # (N, 8): stamp tx ty tz qx qy qz qw

    @classmethod
    def open(cls, root, max_difference: float = 0.02) -> "TumDataset":
        root = Path(root)
        rgb = _read_file_list(root / "rgb.txt")
        depth = _read_file_list(root / "depth.txt")
        rgb_stamps, d_stamps = sorted(rgb), sorted(depth)
        pairs = [(rgb_stamps[ia], rgb[rgb_stamps[ia]][0], d_stamps[ib], depth[d_stamps[ib]][0])
                 for ia, ib in associate(rgb_stamps, d_stamps, max_difference)]
        gt = None
        gt_path = root / "groundtruth.txt"
        if gt_path.exists():
            rows = [[float(x) for x in line.split()]
                    for line in (ln.strip() for ln in gt_path.read_text().splitlines())
                    if line and not line.startswith("#")]
            gt = np.asarray(rows, dtype=np.float64)
        return cls(root=root, pairs=pairs, groundtruth=gt)

    def __len__(self):
        return len(self.pairs)

    def timestamps(self) -> List[float]:
        return [p[0] for p in self.pairs]

    def load_raw(self, i: int):
        """Pair i as stored: (timestamp, rgb u8 (H, W, 3), depth u16 counts)."""
        ts, rgb_file, _, d_file = self.pairs[i]
        rgb = read_png(self.root / rgb_file)
        d16 = read_png(self.root / d_file)
        if rgb.ndim != 3 or rgb.dtype != np.uint8:
            raise ValueError(f"{self.root / rgb_file}: not an 8-bit RGB image")
        if d16.ndim != 2 or d16.dtype != np.uint16:
            raise ValueError(f"{self.root / d_file}: not a 16-bit depth image")
        return ts, rgb, d16

    def load(self, i: int):
        """Pair i -> (timestamp, rgb uint8 (H, W, 3), depth float32 meters)."""
        ts, rgb, d16 = self.load_raw(i)
        return ts, rgb, d16.astype(np.float32) / DEPTH_SCALE


class TumLoader:
    """Decode the pairs `indices` of a TumDataset (all by default) on
    LOADER_THREADS threads, at most LOADER_DEPTH frames ahead; iterate for
    (timestamp, rgb u8, depth float32 meters) in order, as TumDataset.load
    gives them."""

    def __init__(self, dataset: TumDataset, indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.indices = list(range(len(dataset)) if indices is None else indices)
        self._pool = ThreadPoolExecutor(LOADER_THREADS, thread_name_prefix="tum-decode")
        self._ring: collections.deque = collections.deque()
        self._next_submit = 0
        self._pos = 0
        self._lock = threading.Lock()
        # frames asked for before their decode had finished, and the seconds
        # the consumer waited for them
        self.waits = 0
        self.wait_s = 0.0
        self._fill()

    def _fill(self) -> None:
        while (self._pool is not None and len(self._ring) < LOADER_DEPTH
               and self._next_submit < len(self.indices)):
            self._ring.append(self._pool.submit(self.dataset.load,
                                                self.indices[self._next_submit]))
            self._next_submit += 1

    def __len__(self):
        return len(self.indices)

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            if self._pool is None:
                raise RuntimeError("TumLoader is closed")
            if self._pos >= len(self.indices):
                raise StopIteration
            fut = self._ring.popleft()
            self._pos += 1
            self._fill()
        if not fut.done():
            t0 = time.perf_counter()
            futures_wait([fut])
            self.waits += 1
            self.wait_s += time.perf_counter() - t0
        return fut.result()  # a decode error is raised here, at its frame

    def close(self) -> None:
        """Stop the pool: frames not started are dropped, running decodes
        finish first."""
        with self._lock:
            pool, self._pool = self._pool, None
            ring, self._ring = list(self._ring), collections.deque()
        if pool is not None:
            for fut in ring:
                fut.cancel()
            pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trajectory_file(path) -> np.ndarray:
    """A TUM trajectory file -> (N, 8) float64 [stamp tx ty tz qx qy qz qw];
    comments, blank and short lines skipped, commas read as spaces."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.replace(",", " ").split()]
        if len(vals) >= 8:
            rows.append(vals[:8])
    return np.asarray(rows, dtype=np.float64)


def rows_to_poses(rows: np.ndarray) -> np.ndarray:
    """(N, 8) TUM rows [stamp t q(xyzw)] -> (N, 4, 4) float64 poses."""
    n = len(rows)
    T = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    T[:, :3, 3] = rows[:, 1:4]
    x, y, z, w = (rows[:, 4 + i] for i in range(4))
    T[:, 0, 0] = 1 - 2 * (y * y + z * z)
    T[:, 0, 1] = 2 * (x * y - z * w)
    T[:, 0, 2] = 2 * (x * z + y * w)
    T[:, 1, 0] = 2 * (x * y + z * w)
    T[:, 1, 1] = 1 - 2 * (x * x + z * z)
    T[:, 1, 2] = 2 * (y * z - x * w)
    T[:, 2, 0] = 2 * (x * z - y * w)
    T[:, 2, 1] = 2 * (y * z + x * w)
    T[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return T


def write_trajectory(path, stamps: Sequence[float], poses, comment: str = "") -> None:
    """TUM-format trajectory; poses (N, 4, 4) world_T_cam."""
    t, q = se3.pose_to_tum(torch.tensor(np.asarray(poses), dtype=torch.float32))
    t, q = t.numpy(), q.numpy()
    lines = [f"# {comment}"] if comment else []
    for i, ts in enumerate(stamps):
        lines.append(f"{ts:.6f} " + " ".join(f"{x:.7f}" for x in t[i])
                     + " " + " ".join(f"{x:.7f}" for x in q[i]))
    Path(path).write_text("\n".join(lines) + "\n")
