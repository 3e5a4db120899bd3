"""The TUM entry point's host and device parts on the card's machine
(marker `cuda`; each test skips without a CUDA device). Imports torch,
numpy and the port only, no JAX (the card's machine has none; the repo's
tests/conftest.py imports JAX, hence --noconftest there):

    python -m pytest --noconftest tests/test_torch_tum_cuda.py -q

Held here: the PNG codec's round trip at 640x480 (8-bit RGB, 16-bit grey)
with the C unfilter built there; the C unfilter against its numpy plain
version on all five filter types at 2 and 3 bytes a pixel; the voxel map's
ray-walk insert on the card against the CPU on rendered 640x480 node clouds
(the states equal: every update adds one constant, or an integer below
2^24) and its ray lengths on 2^20 random vectors (bitwise); run_tum on the card against run_arrays on the decoded frames (poses equal,
with no online optimize: its atomic adds on the card let two runs differ in
the last bits); a checkpoint continued in a fresh pipeline with the
online optimize on (poses within 1e-5 m); and run_bag on the card against
run_arrays on the frames the bag holds (poses equal, no synchronizing call
in a replayed group).
"""
import warnings

import numpy as np
import pytest
import torch

from rgbdslam_v2_tpu_torch.config import ParameterServer
from rgbdslam_v2_tpu_torch.core import se3
from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT, Intrinsics, backproject_grid
from rgbdslam_v2_tpu_torch.io import (SyntheticWorld, TumDataset, render_sequence,
                                      save_as_tum_dataset)
from rgbdslam_v2_tpu_torch.io import png
from rgbdslam_v2_tpu_torch.io.rosbag import pair_rgbd_messages, write_rgbd_bag
from rgbdslam_v2_tpu_torch.mapping import VoxelMap, VoxelMapConfig
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames():
    dev = _cuda()
    world = SyntheticWorld.create(seed=0, cam=TUM_DEFAULT)
    poses, rgbs, depths = render_sequence(world, 24, seed=2, depth_noise_sigma=0.01,
                                          device=dev)
    d16 = np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    return poses, rgbs, d16


@pytest.mark.cuda
def test_png_round_trip_at_640x480(frames):
    _, rgbs, d16 = frames
    for img in (rgbs[0], d16[0], rgbs[5], d16[5]):
        data = png.encode_png(img)
        inf = png.inflate_png(data)
        plain = inf.image(png.unfilter_numpy(inf.filtered, inf.height, inf.row_bytes, inf.bpp))
        for got in (png.decode_png(data), plain):
            assert got.dtype == img.dtype and got.shape == img.shape
            np.testing.assert_array_equal(got, img)


@pytest.mark.cuda
@pytest.mark.parametrize("bpp,width", [(3, 640), (3, 33), (2, 640), (2, 7)])
def test_c_unfilter_equals_numpy(bpp, width):
    _cuda()
    rng = np.random.default_rng(width + bpp)
    raw = rng.integers(0, 256, (30, width * bpp)).astype(np.uint8)
    raw[::3] //= 9
    filtered = png.filter_rows(raw, bpp, np.arange(30) % 5)
    c = png.unfilter_native(filtered, 30, width * bpp, bpp)
    np.testing.assert_array_equal(c, png.unfilter_numpy(filtered, 30, width * bpp, bpp))
    np.testing.assert_array_equal(c, raw)


@pytest.mark.cuda
def test_voxel_insert_on_the_card_equals_the_cpu(frames, tmp_path):
    dev = _cuda()
    poses, rgbs, d16 = frames
    cfg = VoxelMapConfig(origin=(-3.2, -3.2, -3.2))
    maps = {"cuda": VoxelMap(cfg, device=dev), "cpu": VoxelMap(cfg, device="cpu")}
    cs = Intrinsics(TUM_DEFAULT.fx / 2, TUM_DEFAULT.fy / 2, TUM_DEFAULT.cx / 2,
                    TUM_DEFAULT.cy / 2, 320, 240)
    for k in range(0, 24, 6):
        depth = torch.from_numpy(d16[k, ::2, ::2].astype(np.float32) / 5000.0)
        pose = torch.from_numpy(poses[k])
        pts = se3.apply(pose, backproject_grid(depth, cs).reshape(-1, 3))
        cols = torch.from_numpy(np.ascontiguousarray(rgbs[k, ::2, ::2])).reshape(-1, 3)
        for m in maps.values():
            m.insert_cloud(pts, cols, (depth > 0).reshape(-1), pose[:3, 3])
    a, b = maps["cuda"], maps["cpu"]
    for name in ("logodds", "rgb_sum", "hits"):
        got, want = getattr(a, name).cpu(), getattr(b, name)
        assert torch.equal(got, want), f"{name}: {int((got != want).sum())} entries differ"
    assert int((b.hits > 0).sum()) > 10000
    assert torch.equal(a.occupancy_filter(pts, depth.reshape(-1) > 0).cpu(),
                       b.occupancy_filter(pts, depth.reshape(-1) > 0))
    a.save(tmp_path / "cuda.ot")
    b.save(tmp_path / "cpu.ot")
    assert (tmp_path / "cuda.ot").read_bytes() == (tmp_path / "cpu.ot").read_bytes()


@pytest.mark.cuda
def test_ray_lengths_on_the_card_equal_the_cpu():
    """The voxel map's ray lengths, the same bits on the card and the CPU
    and within the float32 sum's rounding of the exact length: a float32
    sqrt differed between the two devices in the last bit on some rays,
    and one voxel of chip_smoke.py phase 12's map with it."""
    from rgbdslam_v2_tpu_torch.mapping.voxel_map import ray_length

    dev = _cuda()
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.normal(0.0, 2.0, (1 << 20, 3)).astype(np.float32))
    got, want = ray_length(d.to(dev)).cpu(), ray_length(d)
    assert torch.equal(got, want), int((got != want).sum())
    exact = d.double().square().sum(-1).sqrt()  # within the float32 sum's rounding of it
    assert float(((want.double() - exact).abs() / exact).max()) <= 3e-7


@pytest.mark.cuda
def test_run_tum_on_the_card_equals_run_arrays(frames, tmp_path):
    dev = _cuda()
    poses, rgbs, d16 = frames
    save_as_tum_dataset(tmp_path, poses, rgbs, d16)
    ds = TumDataset.open(tmp_path)
    # make_pipe without its online optimize: the optimizer's float
    # index_add_ are atomic adds on the card, so two runs of one optimize
    # may differ in the last bits (chip_smoke.py phase 12 reads ~1e-7 m)
    params = dict(max_keypoints=600, tpu_max_nodes=64, tpu_max_edges=1024,
                  tpu_candidate_batch=8, ransac_iterations=200, optimizer_skip_step=1000,
                  keep_all_nodes=True, observability_threshold=0.5,
                  pose_relative_to="inaffected", emm_skip_step=4, tpu_ingest_format="ydct",
                  tpu_dct_quality="2.7", tpu_depth_bits=10, tpu_frames_per_step=4,
                  tpu_encode_ahead=True)
    a = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(params)), device=dev)
    a.run_tum(ds)
    b = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(params)), device=dev)
    # what run_tum encodes: TumDataset.load's meters
    b.run_arrays(rgbs, d16.astype(np.float32) / np.float32(5000.0), ds.timestamps())
    assert a.manager.n_nodes == b.manager.n_nodes == 24
    np.testing.assert_array_equal(a.manager.poses(), b.manager.poses())
    assert a.manager.statistics() == b.manager.statistics()
    assert a.manager.step_graph.replays > 0


def _replayed_group_syncs(pipe) -> list:
    """Wrap pipe._process_group: for each group that only replayed a
    captured graph, the synchronizing calls it made (sync debug warnings)."""
    sg, group, out = pipe.manager.step_graph, pipe._process_group, []

    def watched(*a):
        before = (sg.captures, sg.eager_groups)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                group(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if (sg.captures, sg.eager_groups) == before:
            out.append([f"{w.filename}:{w.lineno}" for w in rec if "synchroniz" in str(w.message)])

    pipe._process_group = watched
    return out


@pytest.mark.cuda
def test_run_bag_on_the_card_equals_run_arrays(frames, tmp_path):
    """A 24-frame bag (u16 depth written as 32FC1 meters, ground truth on
    /tf) through run_bag with make_pipe's grouping and encode-ahead, against
    run_arrays on the meters and stamps the bag gives back."""
    dev = _cuda()
    poses, rgbs, d16 = frames
    bag = write_rgbd_bag(tmp_path / "seq.bag", np.arange(24) / 30.0, rgbs, d16, gt_poses=poses)
    stamps = [r.stamp for r, _ in pair_rgbd_messages(bag)]
    params = dict(max_keypoints=600, tpu_max_nodes=64, tpu_max_edges=1024,
                  tpu_candidate_batch=8, ransac_iterations=200, optimizer_skip_step=1000,
                  keep_all_nodes=True, observability_threshold=0.5,
                  pose_relative_to="inaffected", emm_skip_step=4, tpu_ingest_format="ydct",
                  tpu_dct_quality="2.7", tpu_depth_bits=10, tpu_frames_per_step=4,
                  tpu_encode_ahead=True)
    a = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(params)), device=dev)
    replayed = _replayed_group_syncs(a)
    a.run_bag(bag)
    b = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(params)), device=dev)
    b.run_arrays(rgbs, d16.astype(np.float32) / np.float32(5000.0), stamps)
    assert a.manager.n_nodes == b.manager.n_nodes == 24
    np.testing.assert_array_equal(a.manager.poses(), b.manager.poses())
    assert a.manager.statistics() == b.manager.statistics()
    assert replayed and not any(replayed), replayed


@pytest.mark.cuda
def test_checkpoint_continues_with_the_online_optimize_on_the_card(frames, tmp_path):
    """save_state after 12 frames, load_state into a fresh pipeline, 12 more
    frames into both with an online optimize every 4: the restored cadence
    optimizes at the same frames, so the poses agree to the optimizer's
    atomic-add noise."""
    dev = _cuda()
    _, rgbs, d16 = frames
    stamps = np.arange(len(rgbs)) / 30.0
    params = dict(max_keypoints=600, tpu_max_nodes=64, tpu_max_edges=1024,
                  tpu_candidate_batch=8, ransac_iterations=200, optimizer_skip_step=4,
                  keep_all_nodes=True, observability_threshold=0.5,
                  pose_relative_to="inaffected", tpu_frames_per_step=4)
    a = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(params)), device=dev)
    a.run_arrays(rgbs[:12], d16[:12], stamps[:12])
    a.manager.save_state(tmp_path / "state.npz")
    b = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(params)), device=dev)
    b.manager.load_state(tmp_path / "state.npz")
    optimizes, optimize = [], b.manager.optimize
    b.manager.optimize = lambda *x, **kw: optimizes.append(1) or optimize(*x, **kw)
    for pipe in (a, b):
        pipe.run_arrays(rgbs[12:], d16[12:], stamps[12:])
    assert len(optimizes) >= 2
    assert a.manager.n_nodes == b.manager.n_nodes == 24
    np.testing.assert_allclose(b.manager.poses(), a.manager.poses(), rtol=0, atol=1e-5)
