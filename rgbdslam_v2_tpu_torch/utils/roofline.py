"""Roofline of the per-frame step: each stage's device time against the card's peaks.

The port's counterpart of ``rgbdslam_v2_tpu/utils/roofline.py``, which
times the step's sub-stages on a TPU with ``jax.profiler`` and rates them
with XLA's cost analysis against TPU peaks. Here the stages the keep-all
step runs (graph/device_step.py, graph/compare.py) are called alone at the
manager's shapes and configuration on one frame: extract (wire decode,
pyramid, the detect kernel, descriptors), match (the B candidates' knn2 and
ratio test), ransac (hypotheses and the refine kernel), emm (both
directions of the pooled EMM) and compare_fused (the three as
``compare_to_candidates``). Per stage:

- device ms: the summed durations of the CUDA activities that a
  torch.profiler trace of ``n_steps`` calls records, a call's mean
  (``device_ms``; "not measured" where no trace holds device activity);
  on a CPU manager the host clock, marked ``~``;
- bytes: each input the stage reads (the candidates' store rows, not the
  whole store) once and each output written once;
- float operations: what ``torch.utils.flop_counter.FlopCounterMode``
  counts (matrix products and convolutions; elementwise work is not
  counted, so the bound is a floor);
- the bound: the larger of bytes over the memory rate and operations over
  the float32 peak (PEAKS: the H100 SXM's 3.35 TB/s and 67 TFLOP/s, 34 at
  float64, the figures PERF.md uses), and the stage's share of it.

The card's name and power limit head the table (``nvidia-smi``, else
``torch.cuda.get_device_name``). No TPU figure is printed.
"""
from __future__ import annotations

import collections
import subprocess
import sys
import time

import torch

# H100 SXM: HBM3 bytes/s, dense float32 and float64 FLOP/s (data sheet)
PEAKS = {"bytes_per_s": 3.35e12, "float32": 67e12, "float64": 34e12}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them; the
    device name alone where nvidia-smi does not answer; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(device)


def _tensors(x):
    """Every tensor in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _tensors(getattr(x, k))


def nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@torch.inference_mode()
def build_stages(manager, rgb, depth):
    """The step's stages at the manager's shapes and configuration, on one
    frame against B candidates (the newest nodes, node 0 repeated in an
    empty graph): OrderedDict name -> (fn, args, bytes the stage must move).
    The candidates' store rows are gathered before, outside the stages."""
    from ..core import se3
    from ..graph.compare import compare_to_candidates, strided_points
    from ..graph.node_store import NodeStore
    from ..ops.emm import emm_pool_maps, observation_likelihood
    from ..ops.matching import match_descriptors
    from ..ops.registration import ransac_register

    m = manager
    cfg = m._step_cfg()
    dev = m.device
    B = m.cand_batch
    packed = m._to_device(m.encode(rgb, depth))
    cand_idx = (torch.arange(B, device=dev) % max(m.n_nodes, 1)).flip(0)
    store = m.store
    rows = NodeStore(*(getattr(store, f)[cand_idx] for f in store.__dataclass_fields__))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cam, cs = cfg["cam"], cfg["cam_small"]
    e = cfg["emm_skip"]

    def extract(p):
        return m._extract(p)

    kp, depth_small, _ = extract(packed)
    desc = kp.desc.to(store.desc.dtype)

    def match(d, v, cd, cv):
        return match_descriptors(d, v, cd, cv, cfg["max_matches"], cfg["ratio"])

    mm = match(desc, kp.valid, rows.desc, rows.kp_valid)
    src = kp.xyz[mm.src_idx]
    dst = torch.gather(rows.xyz, 1, mm.dst_idx[..., None].expand(-1, -1, 3))

    def ransac(s, d, dist, valid):
        return ransac_register(
            gen, s, d, dist, valid, cam_fx=cam.fx, cam_fy=cam.fy,
            n_hypotheses=cfg["n_hypotheses"], sample_size=cfg["sample_size"],
            max_mahal_sq=cfg["max_mahal_sq"], refine_iterations=cfg["refine_iterations"],
            min_inliers=cfg["min_inliers"], sigma_depth=cfg["sigma_depth"],
            projective_iterations=cfg["projective_iterations"], cam_cx=cam.cx, cam_cy=cam.cy)

    reg = ransac(src, dst, mm.dist, mm.valid)
    hs, ws = -(-cs.height // e), -(-cs.width // e)
    flat = ((torch.arange(hs, device=dev) * e)[:, None] * cs.width
            + (torch.arange(ws, device=dev) * e)[None, :]).reshape(-1)
    c_zs = rows.depth[:, flat].reshape(B, hs, ws)
    ident = torch.arange(B, device=dev)

    def emm(T, n_depth, c_zs, c_lohi):
        # graph/compare.py's pooled EMM, both directions
        n_zs = n_depth[::e, ::e]
        a = observation_likelihood(T, strided_points(n_zs, cs, e).reshape(1, -1, 3),
                                   (n_zs > 0).reshape(1, -1), cs, c_lohi, ident,
                                   sigma_depth=cfg["sigma_depth"])
        b = observation_likelihood(se3.inv(T), strided_points(c_zs, cs, e).reshape(B, -1, 3),
                                   (c_zs > 0).reshape(B, -1), cs,
                                   emm_pool_maps(n_depth).reshape(1, -1), None,
                                   sigma_depth=cfg["sigma_depth"])
        return a.inliers + b.inliers, a.outliers + b.outliers

    def compare_fused(k, d, st, ci):
        return compare_to_candidates(
            k, d, st, ci, gen, cs, cam_fx=cam.fx, cam_fy=cam.fy, cam_cx=cam.cx, cam_cy=cam.cy,
            max_matches=cfg["max_matches"], ratio=cfg["ratio"],
            n_hypotheses=cfg["n_hypotheses"], max_mahal_sq=cfg["max_mahal_sq"],
            min_inliers=cfg["min_inliers"], emm_skip=e, sigma_depth=cfg["sigma_depth"],
            sample_size=cfg["sample_size"], refine_iterations=cfg["refine_iterations"],
            projective_iterations=cfg["projective_iterations"], emm_exact=cfg["emm_exact"],
            edge_info_mode=cfg["edge_info_mode"])

    stages = collections.OrderedDict()
    stages["extract"] = (extract, (packed,))
    stages["match"] = (match, (desc, kp.valid, rows.desc, rows.kp_valid))
    stages["ransac"] = (ransac, (src, dst, mm.dist, mm.valid))
    stages["emm"] = (emm, (reg.transform, depth_small, c_zs, rows.emm_lohi))
    stages["compare_fused"] = (compare_fused, (kp, depth_small, store, cand_idx))
    out = collections.OrderedDict()
    for name, (fn, args) in stages.items():
        # compare_fused reads the candidates' rows of the store, not all of it
        read = (nbytes((kp, depth_small, rows)) if name == "compare_fused" else nbytes(args))
        out[name] = (fn, args, read + nbytes(fn(*args)))
    return out


def device_ms(fn, n: int = 20):
    """Mean device time of one call of fn on the card: the summed durations
    of the device activities (kernels, copies) a torch.profiler trace of n
    calls records, after one call outside the trace. A trace without device
    activity is taken again, up to three traces (one on the H100 has come
    back empty for a call that launches a kernel); None when none holds
    any. chip_smoke.py times its kernels with it too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type.name == "CUDA"]
        if spans:
            return sum(spans) / n / 1e3
    return None


def host_ms(fn, n: int) -> float:
    """Mean host-clock ms of one call of fn (a CPU manager: no device)."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


@torch.inference_mode()
def report(manager, rgb, depth, n_steps: int = 10, out=sys.stderr, tag: str = "[roofline]"):
    """Print the stages' table to `out` and return its rows [name, ms,
    float operations, bytes, bound ms, bound_by, host-timed]."""
    from torch.utils.flop_counter import FlopCounterMode

    cuda = manager.device.type == "cuda"
    stages = build_stages(manager, rgb, depth)
    rows = []
    for name, (fn, args, moved) in stages.items():
        with FlopCounterMode(display=False) as fc:
            fn(*args)  # warm-up and the count
        flops = fc.get_total_flops()
        call = lambda: fn(*args)  # noqa: E731
        ms = device_ms(call, n_steps) if cuda else host_ms(call, n_steps)
        t_bytes = moved / PEAKS["bytes_per_s"] * 1e3
        t_ops = flops / PEAKS["float32"] * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        rows.append([name, ms, flops, moved, bound, by, not cuda])
    print(f"{tag} per-frame step stages ({card_line(manager.device)}; peaks "
          f"{PEAKS['bytes_per_s'] / 1e12:.2f} TB/s, {PEAKS['float32'] / 1e12:.0f} TFLOP/s "
          f"float32), one frame, {manager.cand_batch} candidates, {n_steps} calls each:",
          file=out)
    print(f"{tag}   {'stage':<14}{'ms':>9}{'GFLOP':>9}{'MB':>9}{'bound ms':>11}  share", file=out)
    for name, ms, flops, moved, bound, by, host in rows:
        if ms is None:  # no trace held device activity
            cells = f"{'not measured':>9}"
            share = "not measured"
        else:
            cells = f"{ms:8.4f}{'~' if host else ' '}"
            share = f"{100 * bound / max(ms, 1e-9):.2f}% of the {by} bound"
        print(f"{tag}   {name:<14}{cells}{flops / 1e9:9.3f}"
              f"{moved / 1e6:9.3f}{bound:11.6f}  {share}", file=out)
    parts = {r[0]: r[1] for r in rows}
    if None not in parts.values():
        print(f"{tag}   match + ransac + emm {parts['match'] + parts['ransac'] + parts['emm']:.4f} "
              f"ms against compare_fused {parts['compare_fused']:.4f} ms", file=out)
    return rows
