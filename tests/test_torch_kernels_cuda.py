"""The hand-written CUDA kernels against their plain torch versions, on the
card (marker `cuda`; each test skips without a CUDA device). Imports torch,
numpy and the port only, so it runs where JAX is not installed (the repo's
tests/conftest.py imports JAX, hence --noconftest there):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

The detect kernel is bitwise the plain version: equal corner masks and
max abs error 0 on every level, at the adaptive detector's thresholds.
The Kabsch kernel (a double-precision 3x3 SVD in registers) agrees with
the plain torch.linalg.svd + det version, run in float64 on the same
inputs, within 1e-5 on R and 1e-5 m on t for well-conditioned problems,
gives R = I for all-zero weights, and a proper rotation for collinear
points. The RANSAC refine kernel (refits, gates and final score in one
launch) agrees with its plain version run in float64 on the same inputs
(chip_smoke.refine_against_plain: T within 1e-5, inlier masks equal except
at matches whose float64 m2 lies within 1e-4 x max_mahal_sq of the
threshold, n_inliers off by at most their count, rmse within 1e-5
relative) at B in {1, 8, 64} and M in {1, 37, 300, 512}, and with the
matches read from global memory (M = 2000, too many to stage); keeps T
where no match is valid, equals the plain version for zero weights, gives
a proper rotation for collinear inliers, replays in a CUDA graph as it
runs eagerly, and makes no synchronizing call. The native host wire
encoder, built on the card's machine, writes the numpy encoder's yc12
bytes and ydct codes within 1 of numpy's."""
import numpy as np
import pytest
import torch

from chip_smoke import kabsch_problems, refine_against_plain, refine_problems
from rgbdslam_v2_tpu_torch.core import alignment
from rgbdslam_v2_tpu_torch.graph import ingest
from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor
from rgbdslam_v2_tpu_torch.ops import dct_wire, detect, fast, registration
from rgbdslam_v2_tpu_torch.ops.image import resize_bilinear


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.kron(rng.uniform(0, 1, (h // 16 + 1, w // 16 + 1)), np.ones((16, 16)))[:h, :w]
    return (img + rng.normal(0, 0.02, img.shape)).astype(np.float32)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _detect_one(img, threshold):
    """One image as a one-level pyramid: its (H, W) score map."""
    return detect.detect_pyramid([detect.as_level(img)], threshold)[0]


def _assert_bitwise(ref, got):
    assert torch.equal(torch.isfinite(ref), torch.isfinite(got))
    assert int(torch.isfinite(ref).sum()) > 10
    assert torch.equal(ref, got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (400, 533), (333, 444), (278, 370)])
def test_cuda_kernel_matches_plain(shape):
    img = torch.from_numpy(_image(shape, seed=3)).to(_cuda())
    got = _detect_one(img, 0.06)
    ref = fast.detect_corners(img, 0.06)
    torch.cuda.synchronize()
    _assert_bitwise(ref, got)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.06, 0.015, 0.001875])
def test_cuda_pyramid_one_launch_matches_plain(threshold):
    gray = torch.from_numpy(_image((480, 640), seed=7)).to(_cuda())
    images = OrbExtractor().pyramid(gray)
    assert images[0] is gray  # 640 wide: level 0 is read in place
    before = detect.LAUNCHES
    maps = detect.detect_pyramid(images, threshold)
    assert detect.LAUNCHES == before + 1
    torch.cuda.synchronize()
    for img, got in zip(images, maps):
        _assert_bitwise(fast.detect_corners(img, threshold), got)


@pytest.mark.cuda
def test_cuda_padded_resize_matches_unpadded():
    """The pyramid's resizes write padded rows (533 -> 536, 370 -> 372
    floats) in place: bitwise the unpadded product, as on the CPU."""
    gray = torch.from_numpy(_image((480, 640), seed=7)).to(_cuda())
    images = OrbExtractor().pyramid(gray)
    assert [img.stride(0) for img in images] == [640, 536, 444, 372]
    for img in images[1:]:
        assert torch.equal(img, resize_bilinear(gray, tuple(img.shape)))


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    dev = _cuda()
    img = torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError, match="border"):
        detect.detect_pyramid([img], 0.05, border=3)
    with pytest.raises(ValueError, match="aligned"):
        detect.detect_pyramid([torch.zeros(64 * 64 + 1, device=dev)[1:].view(64, 64)], 0.05)
    with pytest.raises(ValueError, match="one device"):
        detect.detect_pyramid([img, img.cpu()], 0.05)


@pytest.mark.cuda
def test_cuda_kernel_ties_and_signed_zeros():
    """FAST's strict comparisons at exact ties (v == center +- threshold) and
    signed zeros (a center equal to the threshold puts lo at +0 against -0
    pixels): the kernel's sign-of-difference tests agree bitwise."""
    rng = np.random.default_rng(8)
    t = 0.25
    values = np.float32([-0.0, 0.0, t, -t, 2 * t, 0.5 * t])
    img = torch.from_numpy(values[rng.integers(0, len(values), (200, 264))]).to(_cuda())
    assert bool((torch.signbit(img) & (img == 0)).any())
    got = _detect_one(img, t)
    ref = fast.detect_corners(img, t)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(ref), torch.isfinite(got))
    assert torch.equal(ref, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 300])
def test_cuda_kabsch_matches_plain(n):
    dev = _cuda()
    src, dst, w = (torch.from_numpy(a).to(dev)
                   for a in kabsch_problems(np.random.default_rng(n), 1000, n))
    before = alignment.LAUNCHES
    got = alignment.weighted_kabsch(src, dst, w)
    assert alignment.LAUNCHES == before + 1
    # the plain version on the same inputs, evaluated in float64: in float32
    # its own rounding reaches 1.1e-5 m in t at these 2-6 m centroids
    ref = alignment.weighted_kabsch_plain(src.double(), dst.double(), w.double()).float()
    torch.cuda.synchronize()
    assert float((got[:, :3, :3] - ref[:, :3, :3]).abs().max()) <= 1e-5
    assert float((got[:, :3, 3] - ref[:, :3, 3]).abs().max()) <= 1e-5
    assert torch.equal(got[:, 3], ref[:, 3])


@pytest.mark.cuda
def test_cuda_kabsch_degenerate_cases():
    dev = _cuda()
    src, dst, _ = (torch.from_numpy(a).to(dev)
                   for a in kabsch_problems(np.random.default_rng(5), 8, 300))
    # no positive weight: R = I, t = 0, finite (LAPACK's SVD of a zero H)
    T = alignment.weighted_kabsch(src, dst, torch.zeros(8, 300, device=dev))
    assert torch.equal(T, torch.eye(4, device=dev).expand(8, 4, 4))
    # collinear points: R is not unique, but must be a proper rotation
    line = torch.linspace(-1.0, 1.0, 300, device=dev)[:, None] * torch.tensor(
        [0.3, -0.5, 0.8], device=dev)
    T = alignment.weighted_kabsch(line[None], 0.5 * line[None] + 2.0,
                                  torch.ones(1, 300, device=dev))[0]
    R = T[:3, :3].double()
    assert torch.isfinite(T).all()
    assert float((R @ R.T - torch.eye(3, device=dev, dtype=torch.float64)).abs().max()) < 1e-5
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5


def _refine_inputs(B, M, seed=0):
    dev = _cuda()
    return [torch.from_numpy(a).to(dev) for a in refine_problems(np.random.default_rng(seed), B, M)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 37, 300, 512, 2000])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_cuda_refine_matches_plain(B, M):
    args = _refine_inputs(B, M, seed=B * 10000 + M)
    before = registration.LAUNCHES
    r = refine_against_plain(args)
    assert registration.LAUNCHES == before + 1
    assert r["ok"], {k: v for k, v in r.items() if k not in ("got", "ref")}
    T, inl, n, rmse = r["got"]
    assert T.shape == (B, 4, 4) and inl.shape == (B, M) and n.dtype == torch.int32
    assert torch.equal(inl.sum(-1, dtype=torch.int32), n)
    assert bool(torch.isfinite(T).all()) and bool(torch.isfinite(rmse).all())


@pytest.mark.cuda
def test_cuda_refine_degenerate_cases():
    dev = _cuda()
    args = _refine_inputs(3, 300, seed=5)
    args[5][0] = False  # no valid match
    args[7][0] = False
    args[2][1] = 0.0  # zero weights: every fit is the identity
    line = torch.linspace(-1.0, 1.0, 300, device=dev)[:, None] * torch.tensor(
        [0.3, -0.5, 0.8], device=dev) + torch.tensor([0.0, 0.0, 3.0], device=dev)
    args[0][2], args[1][2] = line, line + torch.tensor([0.01, 0.0, 0.0], device=dev)
    args[5][2] = args[7][2] = True  # collinear inliers: rank-1 cross-covariance
    T_in = args[6].clone()
    r = refine_against_plain(args)
    T, inl, n, rmse = r["got"]
    assert torch.equal(T[0], T_in[0]) and int(n[0]) == 0 and float(rmse[0]) == 0.0
    assert not bool(inl[0].any())
    assert float((T[1] - r["ref"][0][1]).abs().max()) <= 1e-5
    assert torch.equal(inl[1], r["ref"][1][1]) and int(n[1]) == int(r["ref"][2][1])
    R = T[2, :3, :3].double()
    assert bool(torch.isfinite(T[2]).all())
    assert float((R @ R.T - torch.eye(3, device=dev, dtype=torch.float64)).abs().max()) < 1e-5
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5


@pytest.mark.cuda
def test_cuda_refine_graph_replay_equals_eager():
    args = _refine_inputs(8, 300, seed=9)
    eager = registration.ransac_refine(*args, 4, 9.0)
    static = [a.clone() for a in args]
    registration.ransac_refine(*static, 4, 9.0)  # load the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = registration.LAUNCHES
    with torch.cuda.graph(graph):
        out = registration.ransac_refine(*static, 4, 9.0)
    assert registration.LAUNCHES == before + 1  # counted when captured, not launched
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)
    # a replay reads the static inputs as they are now
    other = _refine_inputs(8, 300, seed=10)
    for s, o in zip(static, other):
        s.copy_(o)
    graph.replay()
    ref = registration.ransac_refine(*other, 4, 9.0)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_refine_makes_no_sync():
    args = _refine_inputs(8, 300, seed=11)
    registration.ransac_refine(*args, 4, 9.0)  # first call loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = registration.ransac_refine(*args, 4, 9.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[0]).all())


@pytest.mark.cuda
def test_native_encoder_equals_numpy_on_the_card_host():
    """The encoder the card's machine builds (g++, or nvcc as C++ without
    one) writes numpy's yc12 bytes for u16 and f32 depth at 10 and 12 bits,
    and ydct codes within 1 of numpy's, whose decodes differ only as the
    differing codes move the pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (480, 640, 3), np.uint8)
    depths = (rng.integers(0, 40000, (480, 640)).astype(np.uint16),
              rng.uniform(0.0, 8.0, (480, 640)).astype(np.float32))
    ingest.reset_encodes()
    for depth in depths:
        for bits in (10, 12):
            np.testing.assert_array_equal(ingest.compact_frame(rgb, depth, 2, bits),
                                          ingest.compact_frame_numpy(rgb, depth, 2, bits))
    sp = dct_wire.spec("2.7")
    native = ingest.compact_frame(rgb, depths[0], 2, 10, sp)
    ref = ingest.compact_frame_numpy(rgb, depths[0], 2, 10, sp)
    nl = dct_wire.dct_luma_len(480, 640, sp)
    np.testing.assert_array_equal(native[nl:], ref[nl:])
    cn = dct_wire.luma_codes_np(native[:nl], 480, 640, sp)
    cr = dct_wire.luma_codes_np(ref[:nl], 480, 640, sp)
    assert np.abs(cn - cr).max() <= 1
    got = dct_wire.decode_luma_dct_np(native[:nl], 480, 640, sp).astype(int)
    want = dct_wire.decode_luma_dct_np(ref[:nl], 480, 640, sp).astype(int)
    # the decodes differ only as far as the differing codes move the pixels
    bound = np.abs(dct_wire.code_delta_np(cn, cr, 480, 640, sp)) + 1.0
    assert (np.abs(got - want) <= bound).all()
    assert ingest.ENCODES == {"native": 5, "numpy": 0}

