"""Synthetic RGB-D world: a textured box room rendered by ray casting.

Port of ``rgbdslam_v2_tpu/io/synthetic.py`` (``SyntheticWorld.create`` with
``texture_contrast``, ``orbit_trajectory``, ``spin_trajectory``, the
renderer, ``_dropout_mask`` and ``render_sequence`` with depth noise and
depth dropout), rendering in torch on the given device: the CUDA card unless
the caller names the CPU (``backend.resolve_device``). The textures and
boxes come from the same numpy seed, so the world is identical to the JAX
package's. Depth noise and the dropout holes' centres and radii are drawn
from a ``torch.Generator``: the same distributions as the JAX draws,
different values; :func:`dropout_mask` takes the draws as arguments, so a
test can give it the JAX package's. :func:`dark_stretch` is the darkening
of ``tools/hard_sequences.py``'s dark-stretch sequence.
:func:`save_as_tum_dataset` writes a sequence as a TUM directory through
the port's PNG writer (``io/png.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import backend
from ..core import se3
from ..core.camera import TUM_DEFAULT, Intrinsics


def _make_face_texture(rng: np.random.Generator, size: int = 512) -> np.ndarray:
    """Corner-rich RGB texture: smooth base + random rectangles + speckle."""
    base = rng.uniform(0.25, 0.75, (8, 8, 3))
    tex = np.kron(base, np.ones((size // 8, size // 8, 1)))
    for _ in range(2):
        tex = (tex + np.roll(tex, 7, 0) + np.roll(tex, -7, 0)
               + np.roll(tex, 7, 1) + np.roll(tex, -7, 1)) / 5.0
    for _ in range(80):
        w = rng.integers(8, size // 4)
        h = rng.integers(8, size // 4)
        x = rng.integers(0, size - w)
        y = rng.integers(0, size - h)
        color = rng.uniform(0.0, 1.0, 3)
        alpha = rng.uniform(0.6, 1.0)
        tex[y : y + h, x : x + w] = (1 - alpha) * tex[y : y + h, x : x + w] + alpha * color
    tex += rng.normal(0, 0.02, tex.shape)
    return np.clip(tex, 0.0, 1.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SyntheticWorld:
    """Box room [0,Lx]x[0,Ly]x[0,Lz] with textured faces and textured
    boxes against the walls."""

    extent: Tuple[float, float, float]
    textures: np.ndarray  # (6, S, S, 3) float32, faces x-,x+,y-,y+,z-,z+
    boxes: Tuple[Tuple[Tuple[float, float, float], Tuple[float, float, float]], ...]
    cam: Intrinsics

    @classmethod
    def create(cls, seed: int = 0, extent=(6.0, 5.0, 3.0), texture_size: int = 512,
               cam: Intrinsics = TUM_DEFAULT, n_boxes: int = 5,
               texture_contrast=1.0) -> "SyntheticWorld":
        """texture_contrast scales each face's texture about its mean: 1.0
        is normal, a 6-tuple gives per-face values (faces x-,x+,y-,y+,z-,z+);
        values near 0 make walls near-featureless (the low-texture world)."""
        rng = np.random.default_rng(seed)
        tex = np.stack([_make_face_texture(rng, texture_size) for _ in range(6)])
        contrasts = ((float(texture_contrast),) * 6 if np.isscalar(texture_contrast)
                     else tuple(float(c) for c in texture_contrast))
        for f, c in enumerate(contrasts):
            if c != 1.0:
                mean = tex[f].mean(axis=(0, 1), keepdims=True)
                tex[f] = np.clip(mean + (tex[f] - mean) * c, 0.0, 1.0)
        Lx, Ly, Lz = extent
        boxes = []
        for k in range(n_boxes):
            sx, sy = rng.uniform(0.5, 1.4, 2)
            sz = rng.uniform(1.0, 0.75 * Lz)
            side = k % 4
            if side == 0:
                ax, ay = 0.05 * Lx, rng.uniform(0.05 * Ly, 0.9 * Ly - sy)
            elif side == 1:
                ax, ay = 0.95 * Lx - sx, rng.uniform(0.05 * Ly, 0.9 * Ly - sy)
            elif side == 2:
                ax, ay = rng.uniform(0.05 * Lx, 0.9 * Lx - sx), 0.05 * Ly
            else:
                ax, ay = rng.uniform(0.05 * Lx, 0.9 * Lx - sx), 0.95 * Ly - sy
            boxes.append(((float(ax), float(ay), 0.0),
                          (float(ax + sx), float(ay + sy), float(sz))))
        return cls(extent=tuple(extent), textures=tex, boxes=tuple(boxes), cam=cam)

    def orbit_trajectory(self, n_frames: int, seed: int = 1, deg_per_frame: float = 2.0,
                         device=None) -> torch.Tensor:
        """Ellipse orbit + bob + panning look-at: (N, 4, 4) world_T_cam on
        `device` (None: the CUDA card)."""
        device = backend.resolve_device(device)
        Lx, Ly, Lz = self.extent
        t = torch.arange(n_frames, device=device, dtype=torch.float32) * (
            deg_per_frame * np.pi / 180.0)
        ph = float(np.random.default_rng(seed).uniform(0, 2 * np.pi))
        rx, ry = 0.22 * Lx, 0.22 * Ly
        pos = torch.stack([Lx / 2 + rx * torch.cos(t + ph), Ly / 2 + ry * torch.sin(t + ph),
                           Lz / 2 + 0.25 * torch.sin(2.0 * t + ph)], dim=-1)
        look = torch.stack([Lx / 2 + 0.48 * Lx * torch.cos(t + ph + 1.2),
                            Ly / 2 + 0.48 * Ly * torch.sin(t + ph + 1.2),
                            0.35 * Lz + 0.15 * Lz * torch.cos(3.0 * t)], dim=-1)
        fwd = look - pos
        fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
        up = torch.tensor([0.0, 0.0, 1.0], device=device).expand_as(fwd)
        right = torch.linalg.cross(fwd, up)
        right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
        down = torch.linalg.cross(fwd, right)
        R = torch.stack([right, down, fwd], dim=-1)
        return se3.from_rt(R, pos)

    def spin_trajectory(self, n_frames: int, seed: int = 1, deg_per_frame: float = 3.0,
                        device=None) -> torch.Tensor:
        """fr1_360-class near-in-place yaw spin (3 deg/frame = 90 deg/s at
        30 Hz) with a small positional wobble: (N, 4, 4) world_T_cam on
        `device` (None: the CUDA card)."""
        device = backend.resolve_device(device)
        Lx, Ly, Lz = self.extent
        t = torch.arange(n_frames, device=device, dtype=torch.float32) * (
            deg_per_frame * np.pi / 180.0)
        ph = float(np.random.default_rng(seed).uniform(0, 2 * np.pi))
        pos = torch.stack([Lx / 2 + 0.03 * Lx * torch.sin(2.1 * t + ph),
                           Ly / 2 + 0.03 * Ly * torch.cos(1.7 * t + ph),
                           Lz / 2 + 0.05 * torch.sin(3.0 * t)], dim=-1)
        yaw = t + ph
        fwd = torch.stack([torch.cos(yaw), torch.sin(yaw), 0.12 * torch.sin(2.0 * t)], dim=-1)
        fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
        up = torch.tensor([0.0, 0.0, 1.0], device=device).expand_as(fwd)
        right = torch.linalg.cross(fwd, up)
        right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
        down = torch.linalg.cross(fwd, right)
        R = torch.stack([right, down, fwd], dim=-1)
        return se3.from_rt(R, pos)


def _sample_tex(tex_face: torch.Tensor, tu01, tv01):
    """Bilinear sample of one (S, S, 3) face texture at normalized coords."""
    S = tex_face.shape[0]
    tu = torch.clamp(tu01, 0.0, 1.0) * (S - 1)
    tv = torch.clamp(tv01, 0.0, 1.0) * (S - 1)
    x0 = torch.floor(tu).long()
    y0 = torch.floor(tv).long()
    x1 = torch.clamp(x0 + 1, max=S - 1)
    y1 = torch.clamp(y0 + 1, max=S - 1)
    fx = (tu - x0)[..., None]
    fy = (tv - y0)[..., None]
    c00, c01 = tex_face[y0, x0], tex_face[y0, x1]
    c10, c11 = tex_face[y1, x0], tex_face[y1, x1]
    return (1 - fy) * ((1 - fx) * c00 + fx * c01) + fy * ((1 - fx) * c10 + fx * c11)


def _render(textures, extent, boxes, poses, cam: Intrinsics):
    """poses (B, 4, 4) -> (rgb float32 (B, H, W, 3) in [0, 1], depth
    (B, H, W), 0 where no surface), on the poses' device."""
    dev = poses.device
    H, W = cam.height, cam.width
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    dir_cam = torch.stack([((u - cam.cx) / cam.fx).expand(H, W),
                           ((v - cam.cy) / cam.fy).expand(H, W),
                           torch.ones((H, W), device=dev)], dim=-1)
    R, o = se3.to_rt(poses)  # (B, 3, 3), (B, 3)
    d = dir_cam[None] @ R.transpose(-1, -2)[:, None]  # (B, H, W, 3)
    o4 = o[:, None, None, :]
    B = poses.shape[0]
    t_best = torch.full((B, H, W), float("inf"), device=dev)
    rgb = torch.zeros((B, H, W, 3), device=dev)
    for face in range(6):
        axis, hi = face // 2, face % 2
        bound = extent[axis] * hi
        da = d[..., axis]
        safe_da = torch.where(da.abs() < 1e-9, torch.full_like(da, 1e-9), da)
        t = (bound - o4[..., axis]) / safe_da
        p = o4 + t[..., None] * d
        a1, a2 = [x for x in (0, 1, 2) if x != axis]
        inb = ((t > 1e-4) & (da.abs() > 1e-9) & (p[..., a1] >= 0) & (p[..., a1] <= extent[a1])
               & (p[..., a2] >= 0) & (p[..., a2] <= extent[a2]))
        color = _sample_tex(textures[face], p[..., a1] / extent[a1], p[..., a2] / extent[a2])
        closer = inb & (t < t_best)
        t_best = torch.where(closer, t, t_best)
        rgb = torch.where(closer[..., None], color, rgb)
    for bmin, bmax in boxes:
        bmin = torch.tensor(bmin, dtype=torch.float32, device=dev)
        bmax = torch.tensor(bmax, dtype=torch.float32, device=dev)
        safe_d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t1 = (bmin - o4) / safe_d
        t2 = (bmax - o4) / safe_d
        tmin = torch.minimum(t1, t2)
        t_near = tmin.max(dim=-1).values
        t_far = torch.maximum(t1, t2).min(dim=-1).values
        hit = (t_near > 1e-4) & (t_near < t_far)
        entry_axis = torch.argmax(tmin, dim=-1)
        p = o4 + t_near[..., None] * d
        rel = (p - bmin) / (bmax - bmin)
        tu = torch.gather(rel, -1, ((entry_axis + 1) % 3)[..., None])[..., 0]
        tv = torch.gather(rel, -1, ((entry_axis + 2) % 3)[..., None])[..., 0]
        color = _sample_tex(textures[0], tu, tv) * (0.55 + 0.15 * entry_axis.float())[..., None]
        closer = hit & (t_near < t_best)
        t_best = torch.where(closer, t_near, t_best)
        rgb = torch.where(closer[..., None], color, rgb)
    depth = torch.where(torch.isfinite(t_best), t_best, torch.zeros((), device=dev))
    return rgb, depth


def draw_holes(generator: torch.Generator, batch: int, n_holes: int, H: int, W: int):
    """Centres and radii of `n_holes` elliptical depth holes for each of
    `batch` frames, drawn as the JAX package draws them (centre uniform
    over the image, radii uniform in [0.02, 0.09) of its height and
    width): (cy, cx, ry, rx), each (batch, n_holes) float32."""
    dev = generator.device
    u = torch.rand((4, batch, n_holes), generator=generator, device=dev)
    return (u[0] * H, u[1] * W, (0.02 + 0.07 * u[2]) * H, (0.02 + 0.07 * u[3]) * W)


def dropout_mask(cy, cx, ry, rx, H: int, W: int) -> torch.Tensor:
    """Elliptical depth holes (specular or absorbing surfaces): centres and
    radii (..., n_holes) -> (..., H, W) bool, True where depth is invalid
    (JAX ``_dropout_mask`` given its draws)."""
    yy = torch.arange(H, dtype=torch.float32, device=cy.device)[:, None, None]
    xx = torch.arange(W, dtype=torch.float32, device=cy.device)[None, :, None]
    sel = (Ellipsis, None, None, slice(None))
    d = ((yy - cy[sel]) / ry[sel]) ** 2 + ((xx - cx[sel]) / rx[sel]) ** 2
    return (d < 1.0).any(dim=-1)


def dark_stretch(rgbs: np.ndarray, lo: float = 0.4, hi: float = 0.6):
    """The dark-stretch sequence's darkening (tools/hard_sequences.py): the
    frames from lo to hi of the sequence scaled to ~3% contrast (lights
    off, auto-exposure failure), depth untouched. Returns (a darkened copy
    of rgbs, first darkened frame, end of the stretch)."""
    a, b = int(lo * len(rgbs)), int(hi * len(rgbs))
    out = rgbs.copy()
    out[a:b] = (out[a:b].astype(np.uint16) * 8 // 255).astype(np.uint8)
    return out, a, b


def render_sequence(world: SyntheticWorld, n_frames: int, seed: int = 1,
                    depth_noise_sigma: float = 0.0, batch: int = 16, trajectory=None,
                    device=None, generator: torch.Generator | None = None,
                    depth_dropout: int = 0):
    """Render a trajectory on `device` (None: the CUDA card; the CPU only
    when named) -> host numpy (poses (N, 4, 4), rgb u8 (N, H, W, 3), depth
    f32 (N, H, W)). depth_noise_sigma > 0 adds sigma*z^2 Gaussian depth
    noise and the 1/5000 m TUM quantization; depth_dropout > 0 punches that
    many elliptical invalid-depth holes into every frame."""
    dev = backend.resolve_device(device)
    poses = (torch.tensor(np.asarray(trajectory), dtype=torch.float32, device=dev)
             if trajectory is not None else world.orbit_trajectory(n_frames, seed=seed, device=dev))
    if (depth_noise_sigma > 0 or depth_dropout > 0) and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    tex = torch.tensor(world.textures, device=dev)
    H, W = world.cam.height, world.cam.width
    rgbs, depths = [], []
    for s in range(0, n_frames, batch):
        rgb, depth = _render(tex, world.extent, world.boxes, poses[s : s + batch], world.cam)
        if depth_noise_sigma > 0:
            noise = torch.randn(depth.shape, generator=generator, device=dev)
            noisy = depth + noise * depth_noise_sigma * depth * depth
            depth = torch.where(depth > 0, noisy, torch.zeros((), device=dev))
            depth = torch.round(depth * 5000.0) / 5000.0
        if depth_dropout > 0:
            holes = dropout_mask(*draw_holes(generator, depth.shape[0], depth_dropout, H, W),
                                 H, W)
            depth = torch.where(holes, torch.zeros((), device=dev), depth)
        rgbs.append((rgb * 255).to(torch.uint8).cpu().numpy())
        depths.append(depth.cpu().numpy())
    return poses.cpu().numpy(), np.concatenate(rgbs, 0), np.concatenate(depths, 0)


def save_as_tum_dataset(out_dir, poses, rgbs, depths, fps: float = 30.0):
    """Write a sequence as a TUM dataset directory: rgb/ and depth/ PNGs
    through the port's PNG writer (frames on several threads: deflate
    releases the GIL), rgb.txt, depth.txt and groundtruth.txt, with the JAX
    package's stamps (1e9 + i / fps) and file names. Depth in float meters
    is written as the JAX package writes it, (d * 5000) truncated to u16;
    u16 depth (TUM counts) is written as it is. Returns the stamps."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from .png import write_png
    from .tum import write_trajectory

    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)
    stamps = [1.0e9 + i / fps for i in range(len(rgbs))]
    names = [(f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png") for ts in stamps]

    def write(i):
        d = np.asarray(depths[i])
        write_png(out / names[i][0], np.asarray(rgbs[i], np.uint8))
        write_png(out / names[i][1],
                  d if d.dtype == np.uint16 else (d * 5000.0).astype(np.uint16))

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(write, range(len(rgbs))))
    for kind, k in (("rgb", 0), ("depth", 1)):
        lines = ["# synthetic"] + [f"{ts:.6f} {n[k]}" for ts, n in zip(stamps, names)]
        (out / f"{kind}.txt").write_text("\n".join(lines) + "\n")
    write_trajectory(out / "groundtruth.txt", stamps, poses, comment="synthetic gt")
    return stamps
