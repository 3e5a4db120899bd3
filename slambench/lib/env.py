"""The run's environment: its caches inside the checkout, the card it runs
on, and the check that the process never loaded JAX or the JAX package."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json beside slambench/
# top-level module names the process must not hold, compared whole (the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "rgbdslam_v2_tpu")
CACHE = ROOT / ".slambench_cache"  # git-ignored; fixed paths, so a second run hits


def set_cache_dirs() -> None:
    """Kernel and build caches in fixed directories inside the checkout
    (the program's own nvcc builds go to rgbdslam_v2_tpu_torch/_build/,
    also inside it); transformers is kept from loading JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(msg: str) -> None:
    print(f"slambench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return "nvidia-smi did not answer"


def require_cards(n: int) -> None:
    """Exit non-zero, printing no result, without n CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("slambench: no CUDA card (the benchmark never falls back to the CPU)")
    if torch.cuda.device_count() < n:
        sys.exit(f"slambench: the cell needs {n} CUDA cards, "
                 f"{torch.cuda.device_count()} present")
