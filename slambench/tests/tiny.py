"""The cells cut to a size the CPU tests can hold: 96x72 frames (the
camera scaled by 0.15, a size the ydct wire takes), a dozen frames a
sequence, small graphs. Only the sizes change; every parameter the cell
states is kept."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from lib import spec  # noqa: E402


def tiny_cell(name: str, frames: int = 12) -> dict:
    cell = copy.deepcopy(spec.cell(name))
    cfg, tr = cell["config_data"], cell["traffic_data"]
    cam = cfg["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] = cam[k] * 0.15
    cam["width"], cam["height"] = 96, 72
    cfg["data"].update(frames=frames, width=96, height=72)
    cfg["params"].update(tpu_max_nodes=32, tpu_max_edges=512, max_keypoints=128,
                         tpu_candidate_batch=4, min_matches=8)
    tr["sequences"] = 2
    tr["warmup_frames"] = min(tr["warmup_frames"], 4)
    tr["judge_edges_per_sequence"] = 8
    tr["judge_frames_per_sequence"] = 2
    if tr["driver"] == "serial":
        tr["chunk_groups"] = 1
        tr["extract_calls"] = 2
    else:
        tr["trace_frames"] = 2
        tr["trace_from"] = tr["warmup_frames"] + 2
    return cell


class Args:
    def __init__(self, workload: str, seed: int, seconds: float, trace: int = 0):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
