"""GraphManager behaviour of the port that needs no JAX oracle: which
optimize calls report their iteration count (the JAX package's rule, set at
rgbdslam_v2_tpu/graph/manager.py in GraphManager.optimize)."""
import numpy as np
import pytest
import torch

from rgbdslam_v2_tpu_torch.config import ParameterServer
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

torch.set_num_threads(1)
CAM = Intrinsics(130.0, 130.0, 80.0, 60.0, 160, 120)
PARAMS = dict(
    max_keypoints=256, tpu_max_nodes=16, tpu_max_edges=128, tpu_candidate_batch=4,
    ransac_iterations=64, min_matches=12, optimizer_skip_step=100, keep_all_nodes=True,
    observability_threshold=0.5, tpu_drain_pipelined=False,
)


@pytest.fixture(scope="module")
def manager():
    world = SyntheticWorld.create(seed=0, texture_size=128, cam=CAM)
    _, rgbs, depths = render_sequence(world, 4, seed=2)
    pipe = SlamPipeline(CAM, ParameterServer(dict(PARAMS)), device="cpu")
    pipe.run_arrays(rgbs, depths, np.arange(4) / 30.0)
    assert pipe.manager.n_nodes == 4
    return pipe.manager


def test_only_a_blocking_optimize_reports_its_iterations(manager):
    manager.last_optimize_iters = -1
    assert np.isnan(manager.optimize(blocking=False))
    assert manager.last_optimize_iters == -1  # the online call leaves it
    chi2 = manager.optimize(blocking=True)
    assert np.isfinite(chi2)
    assert 1 <= manager.last_optimize_iters <= manager.params["optimizer_iterations"]
