"""The hard-sequence slice as a whole: the dark-stretch sequence
(tools/hard_sequences.py at 160x120, its first 48 frames; frames 25-38 at
~3% contrast), rendered once by the JAX package, fed to both packages with
protocol_params(True, use_icp=True, icp_max_iterations=12), as
tests/test_hard_sequences.py runs it in the JAX package.

* keep-all fast path: the retroactive GICP rescue fires in both packages,
  the port's protocol ATE L1 is below the JAX test's 0.06 m bound
  (tests/test_hard_sequences.py:72), and the port's accepted edges are
  within 25% of the JAX package's (ROADMAP F1: RANSAC draws differ).
* slow path (min_translation_meter=0.001, the host-decision path): the
  inline batched rescue fires in both, the port's L1 is below the JAX
  test's 0.25 m bound (:88), accepted edges within 25%."""
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

from hard_sequences import SMALL_CAM, build_sequences, protocol_params, run_sequence  # noqa: E402

from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402

N = 48
# tools/hard_sequences.py protocol_params(small=True)
SMALL = dict(keep_all_nodes=True, observability_threshold=0.5, optimizer_skip_step=10,
             max_keypoints=256, tpu_max_nodes=128, tpu_max_edges=2048,
             tpu_candidate_batch=4, ransac_iterations=128, min_matches=12)
ICP = dict(use_icp=True, icp_max_iterations=12)
PATHS = {  # name: (overrides, JAX L1 bound, count rescues frame by frame)
    "fast": ({}, 0.06, False),
    "slow": ({"min_translation_meter": 0.001}, 0.25, True),
}


@pytest.fixture(scope="module")
def dark_stretch():
    poses, rgbs, depths, note = build_sequences(SMALL_CAM, small=True,
                                                with_fr2=False)["dark_stretch"]()
    return np.asarray(poses)[:N], rgbs[:N], depths[:N], note


def _run_port(seq, over, per_frame, out_dir):
    """tools/hard_sequences.run_sequence's measurements, on the port (CPU)."""
    poses, rgbs, depths, _ = seq
    stamps = np.arange(len(rgbs)) / 30.0
    pipe = SlamPipeline(Intrinsics(*SMALL_CAM), ParameterServer({**SMALL, **ICP, **over}),
                        device="cpu")
    n_icp = 0
    if per_frame:
        for k in range(len(rgbs)):
            pipe.process_frame(rgbs[k], depths[k], float(stamps[k]), poses[0] if k == 0 else None)
            n_icp += sum(d.reason == "icp" for d in pipe.manager.last_decisions)
    else:
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    rep = pipe.evaluation_protocol(out_dir, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
    m = pipe.manager
    return dict(ate=rep.ate_rmse, edges=rep.statistics["active_edges"],
                nodes=rep.statistics["nodes"],
                const_pos_edges=sum(t == EDGE_CONST_POSITION for t in m.host.edge_types),
                icp_rescue_edges=n_icp if per_frame else m.n_icp_rescues,
                icp_rescues=rep.statistics["icp_rescues"])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_dark_stretch_rescue_against_jax(dark_stretch, path, tmp_path):
    over, l1_bound, per_frame = PATHS[path]
    want = run_sequence(SMALL_CAM, dark_stretch, protocol_params(True, **ICP, **over),
                        tmp_path / "jax", rescue_counts=per_frame)
    got = _run_port(dark_stretch, over, per_frame, tmp_path / "port")
    assert want["icp_rescue_edges"] >= 1, want
    assert got["icp_rescue_edges"] >= 1, got  # the rescue fires in the port too
    assert got["icp_rescues"] == got["icp_rescue_edges"]  # statistics() counts them
    l1 = got["ate"].get(1, float("nan"))
    assert np.isfinite(l1) and l1 < l1_bound, (got["ate"], want["ate"])  # the JAX test's bound
    assert abs(got["edges"] - want["edges"]) <= 0.25 * want["edges"], (got, want)  # F1's 25%
    assert got["nodes"] == want["nodes"] == N
