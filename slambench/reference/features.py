"""Keypoint extraction, written plainly: what the configurations' feature
families find in one frame.

A frame (the grey u8 image and the depth metres at stride s, as the wire
delivers them: ``wire.py``) gives up to K keypoints: pixel position uv,
back-projected point xyz, descriptor, valid. Two families:

* ORB (``orb_keepall``): a 4-level pyramid at scale 1.2 (the antialiased
  bilinear resize of ``jax.image.resize``, a triangle kernel stretched by
  the scale); on each level FAST-9/16 corners at threshold 0.06 ranked by
  the Harris response (Sobel gradients, products blurred by a 5-tap
  Gaussian of sigma 1.5, k 0.04), kept at 3x3 maxima and 16 pixels from
  the border; per level a budget of K in proportion to 1.2^-l, taken per
  cell of a 4x4 grid (2 K / 16 a cell) and then overall; each keypoint
  described on the level blurred by sigma 2 in its 32x32 patch: the
  intensity-centroid angle, steered BRIEF of 256 pairs drawn from a
  seeded normal (seed 1234, sigma 15 / 1.9, clipped to 13) and rotated to
  the nearest of 30 angles;
* SIFT (``siftgpu_eval``): 3 octaves (each the half-size resize of the
  last), 6 Gaussian scales an octave from sigma 1.6 at 2^(1/3) apart,
  extrema of the 5 differences over their 3x3x3 neighbourhood with
  |DoG| > 0.015 and the Hessian edge test at ratio 10, 8 pixels from the
  border; a budget of max(32, K >> o) an octave; the orientation as the
  peak of a 36-bin histogram of the gradients in a 17x17 window (Gaussian
  of 1.5 sigma, smoothed twice, interpolated); the 4x4x8 descriptor of
  16x16 rotated samples 0.75 sigma apart (normalized, clipped at 0.2,
  normalized), RootSIFT.

Then, of all levels' keypoints with a depth (the depth at the keypoint's
rounded pixel, nearest-upsampled from stride s, in (min, max) depth), the
K best by score; ties go to the lower index (levels in order, then the
order within a level). Points are ((u - cx) z / fx, (v - cy) z / fy, z).

Everything is float64 PyTorch; `rnd` rounds every image-valued
intermediate (the identity for the reference, bfloat16 for the control).
Positions stay in float64.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import exact_t

FAST_THRESHOLD = 0.06
ORB_LEVELS, ORB_SCALE, BORDER = 4, 1.2, 16
PATCH, PATCH_C, PATCH_R, N_ORIENT_BINS = 32, 15, 15, 30
SIFT_OCTAVES, SIFT_SCALES, SIFT_SIGMA0 = 3, 3, 1.6
SIFT_CONTRAST, SIFT_EDGE, SIFT_BORDER = 0.015, 10.0, 8
RING = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)]


# ---- image operations ------------------------------------------------------
def gaussian_taps(sigma: float, radius: int = None) -> list:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).tolist()


def correlate(img, taps, axis: int, rnd):
    """Correlation with `taps` along one axis of (..., H, W), reflect-padded."""
    r = len(taps) // 2
    n = img.shape[-2 + axis]
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    x = F.pad(img.reshape(-1, 1, *img.shape[-2:]), pad, mode="reflect").reshape(
        *img.shape[:-2], img.shape[-2] + 2 * r * (axis == 0), img.shape[-1] + 2 * r * (axis == 1))
    out = 0.0
    for i, w in enumerate(taps):
        out = out + (x[..., i : i + n, :] if axis == 0 else x[..., :, i : i + n]) * w
    return rnd(out)


def blur(img, sigma: float, rnd, radius: int = None):
    k = gaussian_taps(sigma, radius)
    return correlate(correlate(img, k, 0, rnd), k, 1, rnd)


def max3(img):
    """3x3 maximum of each plane of (..., H, W), -inf outside."""
    H, W = img.shape[-2:]
    return F.max_pool2d(img.reshape(-1, 1, H, W), 3, stride=1, padding=1).reshape(img.shape)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of the antialiased bilinear resize."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    pos = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(pos[None, :] - np.arange(n_in)[:, None]) / ks)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize(img, shape, rnd):
    H, W = img.shape
    h, w = shape
    wy = torch.as_tensor(resize_weights(H, h), dtype=img.dtype, device=img.device)
    wx = torch.as_tensor(resize_weights(W, w), dtype=img.dtype, device=img.device)
    return rnd(rnd(wy.T @ img) @ wx)


def bilinear(img, x, y, plane=None):
    """Sample (H, W), or (S, H, W) at `plane`, at float positions, clamped
    to [0, W - 1.001] x [0, H - 1.001]."""
    H, W = img.shape[-2:]
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    fx, fy = x - x0, y - y0
    flat = img.reshape(-1)
    base = y0 * W + x0 + (0 if plane is None else plane * (H * W))
    return ((1 - fy) * ((1 - fx) * flat[base] + fx * flat[base + 1])
            + fy * ((1 - fx) * flat[base + W] + fx * flat[base + W + 1]))


def top_k(x, k: int):
    """The k largest, descending, the lower index first among ties."""
    val, idx = torch.sort(x, descending=True, stable=True)
    return val[:k], idx[:k]


# ---- ORB -------------------------------------------------------------------
def fast_mask(img, threshold: float):
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([p[3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dy, dx in RING])
    out = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    for m in (ring > img + threshold, ring < img - threshold):
        run = torch.ones_like(m)
        for s in range(9):  # 9 contiguous ring pixels, the ring closed
            run = run & torch.roll(m, -s, 0)
        out |= run.any(0)
    return out


def harris(img, rnd, k: float = 0.04):
    gx = correlate(correlate(img, [1.0, 2.0, 1.0], 0, rnd), [-1.0, 0.0, 1.0], 1, rnd)
    gy = correlate(correlate(img, [-1.0, 0.0, 1.0], 0, rnd), [1.0, 2.0, 1.0], 1, rnd)
    ixx = blur(rnd(gx * gx), 1.5, rnd, radius=2)
    iyy = blur(rnd(gy * gy), 1.5, rnd, radius=2)
    ixy = blur(rnd(gx * gy), 1.5, rnd, radius=2)
    return rnd(rnd(ixx * iyy - ixy * ixy) - rnd(k * (ixx + iyy) ** 2))


def in_border(H: int, W: int, b: int, device):
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)


def corners(img, rnd):
    """Score map: the Harris response at FAST corners that are 3x3 maxima."""
    corner = fast_mask(img, FAST_THRESHOLD)
    score = harris(img, rnd)
    masked = torch.where(corner, score, -math.inf)
    keep = corner & (masked >= max3(masked)) & in_border(*img.shape, BORDER, img.device)
    return torch.where(keep, score, -math.inf)


def grid_select(score, k: int, grid: int = 4):
    """(uv (k, 2), score (k,)): top 2k / grid^2 a cell, then the top k."""
    H, W = score.shape
    gh, gw = -(-H // grid) * grid, -(-W // grid) * grid
    pad = F.pad(score, (0, gw - W, 0, gh - H), value=-math.inf)
    ch, cw = gh // grid, gw // grid
    cells = pad.reshape(grid, ch, grid, cw).permute(0, 2, 1, 3).reshape(grid * grid, ch * cw)
    kc = min(ch * cw, max(1, int(2.0 * k / (grid * grid))))
    cval, cidx = torch.sort(cells, dim=1, descending=True, stable=True)
    cval, cidx = cval[:, :kc], cidx[:, :kc]
    g = torch.arange(grid * grid, device=score.device)[:, None]
    y = ((g // grid) * ch + cidx // cw).reshape(-1)
    x = ((g % grid) * cw + cidx % cw).reshape(-1)
    val, sel = top_k(cval.reshape(-1), k)
    return torch.stack([x[sel], y[sel]], -1).double(), val


def brief_pattern():
    rng = np.random.default_rng(1234)
    pat = np.clip(rng.normal(0.0, PATCH_R / 1.9, size=(256, 2, 2)),
                  -(PATCH_R - 2), PATCH_R - 2).astype(np.float32).astype(np.float64)
    cells = []
    for b in range(N_ORIENT_BINS):
        th = 2.0 * np.pi * b / N_ORIENT_BINS
        c, s = np.cos(th), np.sin(th)
        pq = []
        for pt in (pat[:, 0], pat[:, 1]):
            xi = np.clip(np.round(c * pt[:, 0] - s * pt[:, 1] + PATCH_C).astype(int), 0, PATCH - 1)
            yi = np.clip(np.round(s * pt[:, 0] + c * pt[:, 1] + PATCH_C).astype(int), 0, PATCH - 1)
            pq.append(yi * PATCH + xi)
        cells.append(pq)
    return np.asarray(cells)  # (30, 2, 256) flat patch cells of p and q


def describe_orb(img, uv, rnd):
    """Steered BRIEF of 32x32 patches of `img` (already blurred) at uv."""
    H, W = img.shape
    y0 = torch.clamp(torch.round(uv[:, 1]).long() - PATCH_C, 0, H - PATCH)
    x0 = torch.clamp(torch.round(uv[:, 0]).long() - PATCH_C, 0, W - PATCH)
    r = torch.arange(PATCH, device=img.device)
    flat = img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]].reshape(len(uv), -1)
    d = (torch.arange(PATCH, device=img.device, dtype=torch.float64) - PATCH_C)
    disk = (d[:, None] ** 2 + d[None, :] ** 2 <= PATCH_R**2).to(torch.float64)
    mx = rnd((flat * (disk * d[None, :]).reshape(-1)).sum(-1))
    my = rnd((flat * (disk * d[:, None]).reshape(-1)).sum(-1))
    theta = torch.atan2(my, mx)
    b = torch.remainder(torch.round(theta / (2 * np.pi / N_ORIENT_BINS)).long(), N_ORIENT_BINS)
    cells = torch.as_tensor(brief_pattern(), device=img.device)[b]  # (K, 2, 256)
    diff = torch.gather(flat, 1, cells[:, 0]) - torch.gather(flat, 1, cells[:, 1])
    return torch.where(diff > 0, 1.0, -1.0).to(torch.float64)


def orb_keypoints(gray, K: int, grid: int, rnd):
    """Every level's selected keypoints: (uv full-res, score, desc)."""
    H, W = gray.shape
    inv = [ORB_SCALE**-l for l in range(ORB_LEVELS)]
    uvs, scores, descs = [], [], []
    for lvl in range(ORB_LEVELS):
        s = ORB_SCALE**lvl
        shape = (max(32, int(round(H / s))), max(32, int(round(W / s))))
        img = gray if lvl == 0 else resize(gray, shape, rnd)
        k = max(16, int(math.ceil(K * inv[lvl] / sum(inv))))
        uv, sc = grid_select(corners(img, rnd), k, grid)
        descs.append(describe_orb(blur(img, 2.0, rnd), uv, rnd))
        uvs.append(uv * s)
        scores.append(sc)
    return torch.cat(uvs), torch.cat(scores), torch.cat(descs)


# ---- SIFT ------------------------------------------------------------------
def hessian_ok(d):
    def roll(t, sy, sx):
        return torch.roll(t, (sy, sx), (-2, -1))

    dxx = roll(d, 0, -1) + roll(d, 0, 1) - 2 * d
    dyy = roll(d, -1, 0) + roll(d, 1, 0) - 2 * d
    dxy = 0.25 * (roll(d, -1, -1) + roll(d, 1, 1) - roll(d, -1, 1) - roll(d, 1, -1))
    det = dxx * dyy - dxy * dxy
    return (det > 0) & ((dxx + dyy) ** 2 * SIFT_EDGE < (SIFT_EDGE + 1.0) ** 2 * det)


def sift_orientation(mag, ang, uv, plane, sig):
    """Dominant orientation: the 36-bin histogram's interpolated peak."""
    dev = uv.device
    o = torch.arange(-8, 9, device=dev, dtype=torch.float64)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)
    w = torch.exp(-(ox**2 + oy**2)[None] / (2.0 * (1.5 * sig[:, None]) ** 2))
    x, y = uv[:, 0:1] + ox, uv[:, 1:2] + oy
    m = bilinear(mag, x, y, plane[:, None]) * w
    a = bilinear(ang, x, y, plane[:, None])
    binf = (a + np.pi) * (36 / (2 * np.pi))
    fl = torch.floor(binf)
    b0 = torch.remainder(fl.long(), 36)
    f = binf - fl
    hist = torch.zeros((len(uv), 36), dtype=torch.float64, device=dev)
    hist.scatter_add_(1, b0, m * (1 - f))
    hist.scatter_add_(1, torch.remainder(b0 + 1, 36), m * f)
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, -1)
    at = lambda i: torch.gather(hist, 1, torch.remainder(i, 36)[:, None])[:, 0]  # noqa: E731
    hm, h0, hp = at(peak - 1), at(peak), at(peak + 1)
    den = hm - 2 * h0 + hp
    delta = torch.where(den.abs() > 1e-9, 0.5 * (hm - hp) / den, 0.0)
    return (peak + delta + 0.5) * (2 * np.pi / 36) - np.pi


def sift_describe(mag, ang, uv, theta, plane, sig, rnd):
    dev = uv.device
    g = torch.arange(16, device=dev, dtype=torch.float64)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    step = 0.75 * sig[:, None]
    ox, oy = (gx.reshape(-1) - 7.5) * step, (gy.reshape(-1) - 7.5) * step
    w = torch.exp(-(ox**2 + oy**2) / (2.0 * (8.0 * step) ** 2))
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    x, y = uv[:, 0:1] + c * ox - s * oy, uv[:, 1:2] + s * ox + c * oy
    m = rnd(bilinear(mag, x, y, plane[:, None]) * w)
    a = bilinear(ang, x, y, plane[:, None]) - theta[:, None]
    binf = (a + 4 * np.pi) * (8 / (2 * np.pi))
    fl = torch.floor(binf)
    b0 = torch.remainder(fl.long(), 8)
    f = binf - fl
    cell = ((gy.reshape(-1) // 4) * 4 + gx.reshape(-1) // 4).long()[None] * 8
    desc = torch.zeros((len(uv), 128), dtype=torch.float64, device=dev)
    desc.scatter_add_(1, cell + b0, m * (1 - f))
    desc.scatter_add_(1, cell + torch.remainder(b0 + 1, 8), m * f)
    desc = rnd(desc)
    desc = rnd(desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-9))
    desc = torch.clamp(desc, max=0.2)
    return rnd(desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-9))


def sift_keypoints(gray, K: int, rnd):
    uvs, scores, descs = [], [], []
    img = gray
    kk = 2.0 ** (1.0 / SIFT_SCALES)
    sig = [SIFT_SIGMA0 * kk**i for i in range(SIFT_SCALES + 3)]
    for o in range(SIFT_OCTAVES):
        if o:
            img = resize(img, (img.shape[0] // 2, img.shape[1] // 2), rnd)
        gs = [blur(img, sig[0], rnd)]
        for i in range(1, SIFT_SCALES + 3):
            gs.append(blur(gs[-1], math.sqrt(max(sig[i] ** 2 - sig[i - 1] ** 2, 1e-6)), rnd))
        gs = torch.stack(gs)
        dog = rnd(gs[1:] - gs[:-1])
        hi, lo = max3(dog), -max3(-dog)
        c = dog[1:-1]
        is_max = (c >= hi[1:-1]) & (c >= hi[:-2]) & (c >= hi[2:])
        is_min = (c <= lo[1:-1]) & (c <= lo[:-2]) & (c <= lo[2:])
        keep = ((is_max | is_min) & (c.abs() > SIFT_CONTRAST) & hessian_ok(c)
                & in_border(*img.shape, SIFT_BORDER, img.device))
        score = torch.where(keep, c.abs(), -math.inf)
        S, h, w = score.shape
        val, idx = top_k(score.reshape(-1), max(32, K >> o))
        plane, yx = idx // (h * w), idx % (h * w)
        uv = torch.stack([(yx % w).double(), (yx // w).double()], -1)
        planes = gs[1 : S + 1]
        dx = rnd(0.5 * (torch.roll(planes, -1, -1) - torch.roll(planes, 1, -1)))
        dy = rnd(0.5 * (torch.roll(planes, -1, -2) - torch.roll(planes, 1, -2)))
        mag, ang = rnd(torch.sqrt(dx * dx + dy * dy + 1e-12)), rnd(torch.atan2(dy, dx))
        sg = torch.as_tensor(sig[1 : S + 1], dtype=torch.float64, device=uv.device)[plane]
        theta = sift_orientation(mag, ang, uv, plane, sg)
        descs.append(sift_describe(mag, ang, uv, theta, plane, sg, rnd))
        uvs.append(uv * float(2**o))
        scores.append(val)
    return torch.cat(uvs), torch.cat(scores), torch.cat(descs)


# ---- a frame's keypoints ----------------------------------------------------
def extract(gray8: np.ndarray, depth_small: np.ndarray, config: dict, device="cpu",
            rnd=exact_t) -> dict:
    """The frame's K keypoints: {uv (K, 2), xyz (K, 3), desc (K, D), valid
    (K,)} as float64 / bool numpy arrays."""
    p, cam = config["params"], config["camera"]
    K = p["max_keypoints"]
    s = p["cloud_creation_skip_step"]
    H, W = gray8.shape
    gray = rnd(torch.as_tensor(gray8, dtype=torch.float64, device=device) / 255.0)
    d = torch.as_tensor(depth_small, dtype=torch.float64, device=device)
    d = torch.where((d > p["minimum_depth"]) & (d < p["maximum_depth"]), d, 0.0)
    d = d.repeat_interleave(s, 0).repeat_interleave(s, 1)[:H, :W]
    assert not p["use_feature_min_depth"]
    dmap = torch.where(d > 0, d, math.inf)
    if config["descriptor"] == "binary":
        uv, score, desc = orb_keypoints(gray, K, p["detector_grid_resolution"] + 1, rnd)
    else:
        uv, score, desc = sift_keypoints(gray, K, rnd)
    xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, H - 1)
    z = dmap[yi, xi]
    sel = torch.where(torch.isfinite(score) & torch.isfinite(z), score, -math.inf)
    top, idx = top_k(sel, K)
    valid = torch.isfinite(top)
    uv, z, desc = uv[idx], torch.where(valid, z[idx], 0.0), desc[idx]
    if config["descriptor"] != "binary" and p["squareroot_descriptor_space"]:
        desc = rnd(torch.sqrt(desc / (desc.abs().sum(-1, keepdim=True) + 1e-9)))
    desc = desc * valid[:, None]
    xyz = torch.stack([(uv[:, 0] - cam["cx"]) * z / cam["fx"],
                       (uv[:, 1] - cam["cy"]) * z / cam["fy"], z], -1)
    return {k: v.cpu().numpy() for k, v in
            (("uv", uv), ("xyz", xyz), ("desc", desc), ("valid", valid))}


def compare(prog: dict, ref: dict, binary: bool, tol_px: float = 0.01) -> dict:
    """One frame's keypoints, the program's against the reference's: the
    share of keypoints that one side has and the other has not (by pixel
    position within tol_px), and for those both have, the descriptor's gap
    (binary: the share of its bits that differ; float: the L2 distance)
    and the point's gap in metres."""
    pv, rv = np.nonzero(prog["valid"])[0], np.nonzero(ref["valid"])[0]
    if len(pv) == 0 and len(rv) == 0:
        return {"missing": 0.0, "desc": np.zeros(0), "xyz": np.zeros(0)}
    d = np.abs(prog["uv"][pv][:, None].astype(np.float64) - ref["uv"][rv][None]).max(-1)
    hit = d < tol_px
    both = hit.any(1)
    missing = 1.0 - both.sum() / max(len(pv), len(rv))
    pd = prog["desc"][pv].astype(np.float64)
    rd = ref["desc"][rv]
    desc_gap, xyz_gap = [], []
    for a in np.nonzero(both)[0]:
        cand = np.nonzero(hit[a])[0]
        if binary:
            g = (pd[a][None] != rd[cand]).mean(-1)
        else:
            g = np.linalg.norm(pd[a][None] - rd[cand], axis=-1)
        b = cand[int(np.argmin(g))]
        desc_gap.append(g.min())
        xyz_gap.append(np.abs(prog["xyz"][pv[a]] - ref["xyz"][rv[b]]).max())
    return {"missing": float(missing), "desc": np.asarray(desc_gap), "xyz": np.asarray(xyz_gap)}
