#!/usr/bin/env python3
"""Design variants of the RANSAC refine kernel (csrc/kabsch.cu,
ransac_refine_f32), built side by side from the shipped source by text
substitution, on one CUDA card: for each, the device time of one launch
(torch.profiler, mean of 50) at the main path's shape (8 candidates x 300
matches from chip_smoke.refine_problems) with 0, 1 and 4 refits, the
compiler's register and stack use, and whether it still agrees with the
plain version run in float64 (chip_smoke.refine_against_plain; the
timing-only variant that skips the 3x3 solve does not).

Variants: shipped; fmad_false (built with --fmad=false, no FMA
contraction); old_rotation (each Jacobi rotation from three divisions and
two square roots, as the Kabsch kernel first had it); threads_128 (128
threads a block instead of 256); transposed_reduction (the 16 moments
reduced in a warp by 16 shuffles that halve the values a lane carries,
instead of 80); no_3x3 (R = I, timing only: what the SVD costs).

Usage: python3 tools/refine_variants.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ROTATION = """      const double d = 0.5 * (A[q][q] - A[p][p]);
      const double r = sqrt(d * d + apq * apq);
      const double t = apq / (d >= 0.0 ? d + r : d - r);
      const double c = rsqrt(1.0 + t * t), s = t * c;"""
OLD_ROTATION = """      const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
      const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(1.0 + theta * theta));
      const double c = 1.0 / sqrt(1.0 + t * t), s = t * c;"""
REDUCTION = """#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mo[k] += __shfl_down_sync(0xffffffffu, mo[k], off);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 16; ++k) red[warp][k] = mo[k];"""
TRANSPOSED = """#pragma unroll
    for (int half = 8; half > 0; half >>= 1) {
      const bool up = lane & (2 * half);
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const double send = up ? mo[i] : mo[i + half];
        const double keep = up ? mo[i + half] : mo[i];
        mo[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * half);
      }
    }
    mo[0] += __shfl_xor_sync(0xffffffffu, mo[0], 1);
    if (!(lane & 1)) red[warp][lane >> 1] = mo[0];"""
SOLVE = "      kabsch_rotation(H, R);\n"
NO_SOLVE = ("      for (int r = 0; r < 3; ++r)\n"
            "        for (int c = 0; c < 3; ++c) R[r][c] = r == c ? 1.0 : 0.0;\n")


def variants(src: str) -> dict:
    """name -> (source, extra nvcc flags); each substitution must apply."""
    def sub(old, new):
        if old not in src:
            raise SystemExit(f"refine_variants: the shipped source no longer holds:\n{old}")
        return src.replace(old, new)

    return {
        "shipped": (src, []),
        "fmad_false": (src, ["--fmad=false"]),
        "old_rotation": (sub(ROTATION, OLD_ROTATION), []),
        "threads_128": (sub("constexpr int RT = 256;", "constexpr int RT = 128;"), []),
        "transposed_reduction": (sub(REDUCTION, TRANSPOSED), []),
        "no_3x3": (sub(SOLVE, NO_SOLVE), []),
    }


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import device_ms, refine_against_plain, refine_problems
    from rgbdslam_v2_tpu_torch import backend
    from rgbdslam_v2_tpu_torch.ops import registration

    if not torch.cuda.is_available():
        sys.exit("refine_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    src = (backend.CSRC_DIR / "kabsch.cu").read_text()
    with tempfile.TemporaryDirectory() as td:
        procs = {}
        for name, (text, extra) in variants(src).items():
            cu, so = Path(td) / f"{name}.cu", Path(td) / f"{name}.so"
            cu.write_text(text)
            cmd = [backend._nvcc(), *backend.nvcc_flags("kabsch"), *extra, "-Xptxas", "-v",
                   "-o", str(so), str(cu)]
            procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
        fns = {}
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"refine_variants: {name} did not build:\n{log}")
            use = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                          if "registers" in line})
            print(f"{name}: {' / '.join(use)}", flush=True)
            fn = ctypes.CDLL(str(so)).ransac_refine_f32
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                           + [ctypes.c_double, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[name] = fn
        dev = torch.device("cuda")
        checks = [[torch.from_numpy(a).to(dev)
                   for a in refine_problems(np.random.default_rng(B + M), B, M)]
                  for B, M in ((512, 300), (8, 2000))]
        args = [torch.from_numpy(a).to(dev)
                for a in refine_problems(np.random.default_rng(8), 8, 300)]
        for name, fn in fns.items():
            registration._fn = fn  # the wrapper launches this variant
            agree = all(refine_against_plain(c)["ok"] for c in checks)
            times = []
            for it in (0, 1, 4):
                ms = device_ms(lambda: registration.ransac_refine(*args, it, 9.0), 50)
                times.append(f"{it} refits {1e3 * ms:.2f} us")
            print(f"{name:22s} agrees with the float64 plain version: {agree}; "
                  f"{' | '.join(times)}", flush=True)
        registration._fn = None


if __name__ == "__main__":
    main()
