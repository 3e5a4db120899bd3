"""The benchmark's sequences: a box room rendered by ray casting on the card.

A frozen copy of the port's synthetic renderer
(``rgbdslam_v2_tpu_torch/io/synthetic.py``: ``_make_face_texture``,
``SyntheticWorld.create``, ``orbit_trajectory``, ``_sample_tex``,
``_render`` and the depth noise of ``render_sequence``), kept here so that a
change to the program cannot change the benchmark's inputs. It is data, not
code under test: every run renders its sequences once in set-up into host
arrays, as decoded frames are handed to the pipeline. A traffic mix names
a fixed set of worlds (room and orbit); the run's seed draws their order
and the depth noise, so that every seed runs the same work.

The copy adds two things: the camera's intrinsics are arguments (the cells
run the TUM fr1 camera), and :func:`render_into` writes the frames into
preallocated host arrays batch by batch, so a suite of eight 573-frame
sequences never holds a second copy on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def _from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((*R.shape[:-2], 4, 4), dtype=R.dtype, device=R.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


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
class World:
    """Box room [0,Lx]x[0,Ly]x[0,Lz] with textured faces and textured boxes
    against the walls (the port's ``SyntheticWorld`` at contrast 1)."""

    extent: Tuple[float, float, float]
    textures: np.ndarray  # (6, S, S, 3) float32, faces x-,x+,y-,y+,z-,z+
    boxes: tuple

    @classmethod
    def create(cls, seed: int, extent=(6.0, 5.0, 3.0), texture_size: int = 512,
               n_boxes: int = 5) -> "World":
        rng = np.random.default_rng(seed)
        tex = np.stack([_make_face_texture(rng, texture_size) for _ in range(6)])
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
        return cls(extent=tuple(extent), textures=tex, boxes=tuple(boxes))

    def orbit(self, n_frames: int, seed: int, deg_per_frame: float, device) -> torch.Tensor:
        """Ellipse orbit + bob + panning look-at: (N, 4, 4) world_T_cam."""
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
        return _from_rt(torch.stack([right, down, fwd], dim=-1), pos)


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


def _render(textures, extent, boxes, poses, cam: Camera):
    """poses (B, 4, 4) -> (rgb float32 (B, H, W, 3) in [0, 1], depth
    (B, H, W), 0 where no surface), on the poses' device."""
    dev = poses.device
    H, W = cam.height, cam.width
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    dir_cam = torch.stack([((u - cam.cx) / cam.fx).expand(H, W),
                           ((v - cam.cy) / cam.fy).expand(H, W),
                           torch.ones((H, W), device=dev)], dim=-1)
    R, o = poses[..., :3, :3], poses[..., :3, 3]
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


def world_seeds(world_set: int, world: int) -> Tuple[int, int]:
    """(room, orbit) seeds of world `world` of a traffic mix's fixed set."""
    rng = np.random.default_rng([int(world_set), int(world)])
    return tuple(int(x) for x in rng.integers(0, 2**31, 2))


def run_order(seed: int, n: int) -> np.ndarray:
    """The run's order of a mix's n worlds, drawn from its seed: every seed
    runs the same worlds, so the seed does not change the work."""
    return np.random.default_rng([int(seed) % 2**64, 0]).permutation(n)


def noise_seed(seed: int, index: int) -> int:
    """The depth noise seed of the run's sequence `index`."""
    return int(np.random.default_rng([int(seed) % 2**64, 1, int(index)]).integers(0, 2**31))


def render_frames(world: World, poses: torch.Tensor, cam: Camera, depth_noise_sigma: float,
                  generator, batch: int = 16):
    """Yield (first frame, rgb u8 (b, H, W, 3), depth float32 metres (b, H,
    W)) on the poses' device, `batch` frames at a time, as the port's
    render_sequence renders them (its noise drawn from `generator`)."""
    dev = poses.device
    tex = torch.tensor(world.textures, device=dev)
    for s in range(0, poses.shape[0], batch):
        rgb, depth = _render(tex, world.extent, world.boxes, poses[s : s + batch], cam)
        if depth_noise_sigma > 0:
            noise = torch.randn(depth.shape, generator=generator, device=dev)
            noisy = depth + noise * depth_noise_sigma * depth * depth
            depth = torch.where(depth > 0, noisy, torch.zeros((), device=dev))
            depth = torch.round(depth * 5000.0) / 5000.0
        yield s, (rgb * 255).to(torch.uint8), depth


@torch.inference_mode()
def render_into(rgb_out: np.ndarray, depth_out: np.ndarray, world_set: int, world: int,
                noise: int, cam: Camera, deg_per_frame: float, depth_noise_sigma: float,
                device) -> np.ndarray:
    """Render world `world` of the fixed set `world_set` into rgb_out (N,
    H, W, 3) u8 and depth_out (N, H, W) u16 TUM counts (5000 a metre), with
    sigma z^2 Gaussian depth noise drawn from the seed `noise` and the
    1/5000 m quantization. Returns its world_T_cam poses (N, 4, 4) float32."""
    room, orbit = world_seeds(world_set, world)
    w = World.create(room)
    poses = w.orbit(rgb_out.shape[0], orbit, deg_per_frame, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(noise)
    for s, rgb, depth in render_frames(w, poses, cam, depth_noise_sigma, gen):
        rgb_out[s : s + rgb.shape[0]] = rgb.cpu().numpy()
        # as the port's chip_smoke.render_bench quantizes: counts rounded half up
        depth_out[s : s + rgb.shape[0]] = np.clip(
            depth.cpu().numpy() * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    return poses.cpu().numpy()


def trajectory_speeds(poses: np.ndarray, fps: float) -> Tuple[float, float]:
    """Mean translational (m/s) and angular (deg/s) speed of world_T_cam
    poses sampled at fps, as TUM's dataset statistics state them."""
    rel = np.linalg.inv(poses[:-1]) @ poses[1:]
    trans = np.linalg.norm(rel[:, :3, 3], axis=-1)
    cos = np.clip((np.trace(rel[:, :3, :3], axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    return float(trans.mean() * fps), float(np.degrees(np.arccos(cos)).mean() * fps)
