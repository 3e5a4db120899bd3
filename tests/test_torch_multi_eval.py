"""The port's parallel/multi_eval.py and
pipeline/batch_eval.evaluate_sequences_sharded against the JAX package's,
on the JAX test's two 6-frame 160x120 sequences (tests/test_parallel.py):
both recover each trajectory within L0 < 0.02 m (RANSAC draws differ,
ROADMAP F1, so the poses are not bitwise equal); 2 CPU shards equal no
mesh bit for bit; the summary.csv of both packages has the same header
and rows (sequence, config, nodes and edges)."""
import csv

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.pipeline.batch_eval import (  # noqa: E402
    evaluate_sequences_sharded as jeval_sharded)
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import detect, registration  # noqa: E402
from rgbdslam_v2_tpu_torch.parallel import candidate_mesh, vo_trajectories_sharded  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline.batch_eval import evaluate_sequences_sharded  # noqa: E402

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
PARAMS = dict(tpu_mesh_devices=2, max_keypoints=256, ransac_iterations=128, min_matches=10,
              max_matches=128)


@pytest.fixture(scope="module")
def sequences():
    """The JAX test's sequences: worlds 0 and 1, orbits 10 and 11; grey
    as the mean of the u8 channels, ground truth from the first pose."""
    seqs = []
    for s in range(2):
        world = JWorld.create(seed=s, texture_size=256, cam=JIntrinsics(*CAM))
        poses, rgbs, depths = jrender(world, 6, seed=10 + s)
        grays = np.stack([r.mean(-1).astype(np.float32) for r in rgbs])
        rel = np.linalg.inv(poses[0])[None] @ poses
        seqs.append((f"seq{s}", grays, np.stack(depths), rel))
    return seqs


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_vo_sharded_matches_jax(sequences, tmp_path):
    jres = jeval_sharded(sequences, JIntrinsics(*CAM), JParams(dict(PARAMS)),
                         out_dir=tmp_path / "jax")
    detect.reset_launches()
    registration.reset_launches()
    tres = evaluate_sequences_sharded(sequences, Intrinsics(*CAM), ParameterServer(dict(PARAMS)),
                                      out_dir=tmp_path / "torch", device="cpu")
    for res in (jres, tres):
        assert [r.name for r in res] == ["seq0", "seq1"]
        for r in res:
            assert r.ate_by_level[0] < 0.02, f"{r.name} VO ATE {r.ate_by_level[0]}"
    # on the CPU the wrappers run the plain versions: no kernel launches
    assert detect.LAUNCHES == 0 and registration.LAUNCHES == 0
    jrows, trows = _rows(tmp_path / "jax" / "summary.csv"), _rows(tmp_path / "torch" / "summary.csv")
    assert jrows[0] == trows[0]
    assert [(r[0], r[1], r[-2]) for r in jrows[1:]] == [(r[0], r[1], r[-2]) for r in trows[1:]]
    for jr, tr in zip(jrows[1:], trows[1:]):
        assert abs(int(jr[-1]) - int(tr[-1])) <= 1  # RANSAC successes


def test_two_shards_equal_no_mesh(sequences):
    grays = np.stack([s[1] for s in sequences])
    depths = np.stack([s[2] for s in sequences])
    ext = OrbExtractor(max_keypoints=256)
    a = vo_trajectories_sharded(candidate_mesh(2, platform="cpu"), grays, depths, 7, ext,
                                Intrinsics(*CAM))
    b = vo_trajectories_sharded(None, grays, depths, 7, ext, Intrinsics(*CAM), device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.poses.shape == (2, 6, 4, 4) and bool(a.ok.all())
