"""The pyramid layout of the detect kernel (ops/detect.py) on the CPU: the
level table, the level layout of the extractor's pyramid (levels padded only
where the width needs it, level 0 used in place), the flat unpitched score
maps, and the multi-level plain path against one plain call per level
(bitwise). Imports torch, numpy and the port only."""
import numpy as np
import pytest
import torch

from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor
from rgbdslam_v2_tpu_torch.ops import detect, fast
from rgbdslam_v2_tpu_torch.ops.image import resize_bilinear

torch.set_num_threads(1)

# (pitch, h, w, out_off, blocks_x, blocks_y, block_start) per level
TABLES = {
    (480, 640): [
        [640, 480, 640, 0, 6, 15, 0],
        [536, 400, 533, 307200, 5, 13, 90],
        [444, 333, 444, 520400, 4, 11, 155],
        [372, 278, 370, 668252, 4, 9, 199],
    ],
    (120, 160): [
        [160, 120, 160, 0, 2, 4, 0],
        [136, 100, 133, 19200, 2, 4, 8],
        [112, 83, 111, 32500, 1, 3, 16],
        [96, 69, 93, 41716, 1, 3, 19],
    ],
}
OUTPUT_SIZES = {(480, 640): 771112, (120, 160): 48133}


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.kron(rng.uniform(0, 1, (h // 16 + 1, w // 16 + 1)), np.ones((16, 16)))[:h, :w]
    return torch.from_numpy((img + rng.normal(0, 0.02, img.shape)).astype(np.float32))


def _detect_one(img, threshold):
    """One image as a one-level pyramid: its (H, W) score map."""
    return detect.detect_pyramid([detect.as_level(img)], threshold)[0]


@pytest.mark.parametrize("frame", sorted(TABLES))
def test_level_table(frame):
    table = detect.level_table(OrbExtractor().level_shapes(*frame))
    np.testing.assert_array_equal(table, np.int32(TABLES[frame]))
    assert detect.output_size(table) == OUTPUT_SIZES[frame]
    # 16-byte rows and score-map starts; tiles cover each level; maps apart
    assert (table[:, detect.PITCH] % 4 == 0).all() and (table[:, detect.OUT_OFF] % 4 == 0).all()
    assert (table[:, detect.PITCH] >= table[:, detect.W]).all()
    assert (table[:, detect.PITCH] - table[:, detect.W] < 4).all()
    assert (table[:, detect.BLOCKS_X] * detect.TILE_W >= table[:, detect.W]).all()
    assert (table[:, detect.BLOCKS_Y] * detect.TILE_H >= table[:, detect.H]).all()
    ends = table[:, detect.OUT_OFF] + table[:, detect.H] * table[:, detect.W]
    assert (ends[:-1] <= table[1:, detect.OUT_OFF]).all()
    counts = table[:, detect.BLOCKS_X] * table[:, detect.BLOCKS_Y]
    np.testing.assert_array_equal(table[1:, detect.BLOCK_START], np.cumsum(counts)[:-1])


def test_level_table_limits():
    with pytest.raises(ValueError):
        detect.level_table([])
    with pytest.raises(ValueError):
        detect.level_table([(64, 64)] * (detect.MAX_LEVELS + 1))


def test_pyramid_levels_are_in_the_level_layout():
    """Level 0 is the frame itself; a resize writes its padded rows in place
    and equals the unpadded resize bitwise; the score maps are contiguous
    views of one flat buffer at the table's offsets."""
    gray = _image((120, 160), seed=4)
    images = OrbExtractor().pyramid(gray)
    table = detect.level_table([img.shape for img in images])
    assert len(images) == 4 and images[0] is gray
    for row, img in zip(table, images):
        assert img.stride() == (int(row[detect.PITCH]), 1) and img.data_ptr() % 16 == 0
        assert detect.as_level(img) is img
    for img in images[1:]:
        assert torch.equal(img, resize_bilinear(gray, tuple(img.shape)))
    maps = detect.detect_pyramid(images, 0.06)
    base = maps[0].data_ptr()
    for row, m in zip(table, maps):
        assert m.is_contiguous() and m.shape == (int(row[detect.H]), int(row[detect.W]))
        assert m.data_ptr() - base == 4 * int(row[detect.OUT_OFF])


def test_as_level_copies_only_what_does_not_fit():
    img = _image((64, 90), seed=9)
    lvl = detect.as_level(img)  # 90 wide: rows padded to 92
    assert lvl is not img and lvl.stride() == (92, 1) and torch.equal(lvl, img)
    wide = _image((64, 96), seed=9)
    assert detect.as_level(wide) is wide
    view = wide[:, 1:95]  # rows 96 floats apart, but the start is 4 bytes in
    lvl = detect.as_level(view)
    assert lvl is not view and lvl.data_ptr() % 16 == 0 and torch.equal(lvl, view)


@pytest.mark.parametrize("threshold", [0.06, 0.015, 0.001875])
def test_plain_pyramid_equals_single_level_calls(threshold):
    """The multi-level plain path is bitwise the per-level plain version, at
    the adaptive detector's highest, middle and lowest thresholds."""
    images = OrbExtractor().pyramid(_image((120, 160), seed=5))
    before = detect.LAUNCHES
    maps = detect.detect_pyramid(images, threshold)
    assert detect.LAUNCHES == before  # the plain version counts no launch
    n_corners = 0
    for img, got in zip(images, maps):
        ref = fast.detect_corners(img, threshold=threshold)
        assert torch.equal(got, ref)
        n_corners += int(torch.isfinite(ref).sum())
    assert n_corners > 20


def test_single_level_wrapper_is_the_plain_version_on_cpu():
    img = _image((96, 130), seed=6)
    torch.testing.assert_close(_detect_one(img, 0.05), fast.detect_corners(img, 0.05),
                               rtol=0, atol=0)


def test_bad_inputs_raise():
    img = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="border"):
        detect.detect_pyramid([img], 0.05, border=3)
    with pytest.raises(ValueError, match="border"):
        detect.detect_pyramid([img], 0.05, border=32)
    with pytest.raises(ValueError, match="float32"):
        detect.detect_pyramid([img.double()], 0.05)
    with pytest.raises(ValueError, match="as_level"):
        detect.detect_pyramid([torch.zeros(64, 66)], 0.05)  # rows not 16 bytes apart
    with pytest.raises(ValueError, match="levels"):
        detect.detect_pyramid([], 0.05)
    with pytest.raises(ValueError, match="CUDA"):
        detect.detect_pyramid_cuda([img], 0.05)  # a CPU tensor never reaches the kernel
