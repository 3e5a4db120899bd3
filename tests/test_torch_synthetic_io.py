"""The port's hard-sequence world builders and trajectory I/O and
evaluation against the JAX package's, on the same numpy inputs:
``texture_contrast``, ``spin_trajectory``, the depth-dropout mask (given
the JAX package's own jax.random draws), ``dark_stretch``,
``read_trajectory_file``, ``rows_to_poses``, ``evaluate_rpe`` and
``wilcoxon_compare`` (the oracles of tests/test_io_eval.py and
tests/test_eval_stats.py); and the renderer's device rule."""
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.eval import evaluate_rpe as jevaluate_rpe  # noqa: E402
from rgbdslam_v2_tpu.eval.stats import wilcoxon_compare as jwilcoxon  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld  # noqa: E402
from rgbdslam_v2_tpu.io import render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.io import synthetic as jsynthetic  # noqa: E402
from rgbdslam_v2_tpu.io import tum as jtum  # noqa: E402

from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.eval.ate import evaluate_rpe  # noqa: E402
from rgbdslam_v2_tpu_torch.eval.stats import wilcoxon_compare  # noqa: E402
from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence  # noqa: E402
from rgbdslam_v2_tpu_torch.io import synthetic  # noqa: E402
from rgbdslam_v2_tpu_torch.io.tum import (read_trajectory_file, rows_to_poses,  # noqa: E402
                                          write_trajectory)

CAM = Intrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120)
LOW_TEXTURE = (1.0, 0.04, 0.04, 0.04, 1.0, 1.0)  # tools/hard_sequences.py's low_texture world


def test_render_sequence_without_a_device_needs_cuda():
    """None means the card: without CUDA the renderer raises instead of
    running on the CPU; the CPU runs when named."""
    world = SyntheticWorld.create(seed=0, texture_size=64, cam=CAM)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_sequence(world, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        world.spin_trajectory(2)
    poses, rgbs, depths = render_sequence(world, 1, device="cpu")
    assert rgbs.shape == (1, 120, 160, 3) and depths.shape == (1, 120, 160)


@pytest.mark.parametrize("contrast", [LOW_TEXTURE, 0.3])
def test_texture_contrast_matches_jax(contrast):
    want = np.asarray(JWorld.create(seed=3, texture_size=64, texture_contrast=contrast).textures)
    got = SyntheticWorld.create(seed=3, texture_size=64, texture_contrast=contrast).textures
    np.testing.assert_array_equal(got, want)  # same numpy operations: bitwise


def test_spin_trajectory_matches_jax():
    want = np.asarray(JWorld.create(seed=0, texture_size=64).spin_trajectory(
        120, seed=2, deg_per_frame=3.0))
    got = SyntheticWorld.create(seed=0, texture_size=64).spin_trajectory(
        120, seed=2, deg_per_frame=3.0, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)  # float32 trigonometry, as the orbit


def test_dropout_mask_matches_jax_given_its_draws():
    """The port's mask of centres and radii drawn by jax.random exactly as
    JAX _dropout_mask draws them equals _dropout_mask."""
    H, W, n = 120, 160, 8
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsynthetic._dropout_mask(key, H, W, n))
        k1, k2, k3 = jax.random.split(key, 3)
        cy = jax.random.uniform(k1, (n,)) * H
        cx = jax.random.uniform(k2, (n,)) * W
        rad = jax.random.uniform(k3, (n, 2), minval=0.02, maxval=0.09)
        draws = [torch.from_numpy(np.array(a)) for a in (cy, cx, rad[:, 0] * H, rad[:, 1] * W)]
        got = synthetic.dropout_mask(*draws, H, W).numpy()
        np.testing.assert_array_equal(got, want)  # same float32 operations: equal masks
        assert 0.02 < want.mean() < 0.6


def test_depth_dropout_punches_holes():
    """render_sequence(depth_dropout=) zeroes depth inside the drawn holes
    and only there; draws are reproducible from the seed."""
    world = SyntheticWorld.create(seed=5, texture_size=64, cam=CAM)
    _, _, full = render_sequence(world, 3, seed=6, device="cpu")
    _, _, holed = render_sequence(world, 3, seed=6, depth_dropout=8, device="cpu")
    _, _, again = render_sequence(world, 3, seed=6, depth_dropout=8, device="cpu")
    np.testing.assert_array_equal(holed, again)
    gone = (full > 0) & (holed == 0)
    assert 0.02 < gone.mean() < 0.6
    np.testing.assert_array_equal(holed[~gone], full[~gone])
    # the fraction of depth lost matches the JAX renderer's within its spread
    _, _, jfull = jrender(JWorld.create(seed=5, texture_size=64, cam=CAM), 3, seed=6)
    _, _, jholed = jrender(JWorld.create(seed=5, texture_size=64, cam=CAM), 3, seed=6,
                           depth_dropout=8)
    jgone = ((jfull > 0) & (jholed == 0)).mean()
    assert abs(gone.mean() - jgone) < 0.15, (gone.mean(), jgone)


def test_dark_stretch_matches_the_hard_sequence_tool():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from hard_sequences import SMALL_CAM, build_sequences

    _, want, _, _ = build_sequences(SMALL_CAM, small=True, with_fr2=False)["dark_stretch"]()
    _, rgbs, _ = jrender(JWorld.create(seed=7, cam=SMALL_CAM), 64, seed=8,
                         depth_noise_sigma=0.01)
    got, lo, hi = synthetic.dark_stretch(rgbs)
    np.testing.assert_array_equal(got, want)
    assert (lo, hi) == (25, 38)
    np.testing.assert_array_equal(rgbs[:lo], got[:lo])
    assert got[lo:hi].max() <= 8


def test_read_trajectory_file_and_rows_to_poses_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    poses = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(size=(10, 6)).astype(np.float32))))
    stamps = [100.0 + 0.1 * i for i in range(10)]
    path = tmp_path / "traj.txt"
    write_trajectory(path, stamps, poses, comment="test")
    with open(path, "a") as f:
        f.write("\n# trailing comment\n1.0, 2.0, 3.0\n")  # commas, a short line
    rows = read_trajectory_file(path)
    np.testing.assert_array_equal(rows, jtum.read_trajectory_file(path))
    assert rows.shape == (10, 8)
    np.testing.assert_array_equal(rows_to_poses(rows), jtum.rows_to_poses(rows))  # numpy: bitwise
    np.testing.assert_allclose(rows_to_poses(rows)[:, :3, :3], poses[:, :3, :3], atol=1e-4)


def test_evaluate_rpe_matches_jax():
    rng = np.random.default_rng(2)
    gt = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.3, (30, 6)).astype(np.float32))))
    noise = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.01, (30, 6)).astype(np.float32))))
    est = gt @ noise
    for delta in (1, 3):
        want = jevaluate_rpe(est, gt, delta=delta)
        got = evaluate_rpe(est, gt, delta=delta)
        for g, w in zip(got, want):
            assert g.n_pairs == w.n_pairs == 30 - delta
            for k in ("rmse", "mean", "median", "max"):
                # float32 products in another order: 1e-5 m / rad
                assert abs(getattr(g, k) - getattr(w, k)) < 1e-5, (k, g, w)
    zero_t, zero_r = evaluate_rpe(gt, gt)
    assert zero_t.rmse < 1e-5 and zero_r.rmse < 1e-3  # float32 arccos near 1


@pytest.mark.parametrize("case", ["better", "noise", "tied"])
def test_wilcoxon_compare_matches_jax(case):
    rng = np.random.default_rng(0)
    base = rng.uniform(0.02, 0.08, 12)
    other = {"better": base * 0.6 + rng.normal(0, 0.001, 12),
             "noise": base + rng.normal(0, 1e-4, 12), "tied": base}[case]
    assert wilcoxon_compare(other, base) == jwilcoxon(other, base)  # the same scipy call
    with pytest.raises(ValueError):
        wilcoxon_compare(base, base[:-1])
