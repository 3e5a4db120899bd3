"""Device selection, float32 precision settings and the CUDA kernel build.

JAX counterpart: ``rgbdslam_v2_tpu/__init__.py`` (global "highest" matmul
precision) plus the TPU-backend gate in ``models/orb.py``. Here:

* :func:`resolve_device` picks the device: the card unless the caller
  names the CPU. Asking for CUDA where none is present raises; nothing
  falls back silently.
* :func:`set_precision` turns TF32 off for matmuls and cuDNN convolutions,
  matching the reference's "highest" float32 precision.
* :func:`load_kernel_library` is the one place that compiles a native
  source into a plain-C shared library and loads it with ``ctypes``: a
  ``csrc/*.cu`` kernel source with ``nvcc``, or a host source
  (``HOST_SOURCES``: the wire encoder ``native/compact_ingest.cpp`` and the
  PNG unfilter ``csrc/png_unfilter.cpp``) with ``g++ -O3
  -ffp-contract=off`` (``nvcc -x c++`` where there is no ``g++``). The
  build is keyed by a hash of the source, the compiler and its flags,
  lands in the git-ignored ``_build/`` directory beside this file (a
  temporary file renamed into place, so concurrent builds are safe), and a
  failed build raises with the compiler's output.
  :func:`build_kernel_libraries` builds several sources at once, one
  compiler process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

import torch

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# flags of one source: detect_corners.cu repeats its plain torch version's
# float32 operation order and, without FMA contraction, rounds identically;
# kabsch.cu computes in double against a float64 reference and contracts
SOURCE_FLAGS = {"detect_corners": ["--fmad=false"]}
# host sources, built for the CPU: the wire encoder shared with the JAX
# package (compiled alone, unedited; its chroma must round as numpy's
# float32 expression does, so no FMA contraction) and the PNG row unfilter
# of io/png.py
HOST_SOURCES = {"compact_ingest": _PKG_DIR.parent / "native" / "compact_ingest.cpp",
                "png_unfilter": CSRC_DIR / "png_unfilter.cpp"}
HOST_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_libs: dict = {}
_lock = threading.Lock()
_constants: dict = {}


def set_precision() -> None:
    """Full float32 for matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card. A CUDA request (None included) without a
    CUDA device raises RuntimeError: the CPU runs only when asked for by
    name (device="cpu")."""
    set_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def constant(key, build, device) -> torch.Tensor:
    """A device copy of a host constant (build() -> array), made once per
    device: a per-call copy from pageable host memory would synchronize the
    stream."""
    dev = torch.device(device)
    t = _constants.get((key, dev))
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(build()).to(dev)
        _constants[(key, dev)] = t
    return t


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def nvcc_flags(name: str) -> List[str]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def host_compiler() -> List[str]:
    """The command prefix that builds a host source: g++ where there is
    one, else nvcc compiling it as C++ with the same host flags."""
    gxx = shutil.which("g++")
    if gxx:
        return [gxx, *HOST_FLAGS]
    return [_nvcc(), "-x", "c++", "-O3", "-shared", "-Xcompiler", "-fPIC,-ffp-contract=off"]


def source_path(name: str) -> Path:
    return HOST_SOURCES.get(name, CSRC_DIR / f"{name}.cu")


def _compile_command(name: str) -> List[str]:
    """The compiler and flags of one source, without its input and output."""
    return host_compiler() if name in HOST_SOURCES else [_nvcc(), *nvcc_flags(name)]


def library_path(name: str, command: List[str] = None) -> Path:
    """Build location of a source, keyed by its hash, the compiler's name
    and the flags."""
    command = command or _compile_command(name)
    key = " ".join([Path(command[0]).name, *command[1:]])
    digest = hashlib.sha256(source_path(name).read_bytes() + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernel_libraries(names) -> List[Path]:
    """Compile every source whose hash-keyed library is missing, one
    compiler process a source, all started together; raise with the
    compiler's output if any fails."""
    outs, jobs = [], []
    for name in names:
        command = _compile_command(name)
        out = library_path(name, command)
        outs.append(out)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [*command, "-o", str(tmp), str(source_path(name))]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
        except OSError as e:
            for *_, running in jobs:
                running.kill()
                running.communicate()
            raise RuntimeError(f"cannot start the compiler for {source_path(name).name}: "
                               f"{' '.join(cmd)}: {e}") from e
        jobs.append((name, out, tmp, cmd, proc))
    errors = []
    for name, out, tmp, cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{Path(cmd[0]).name} failed building {source_path(name).name} "
                          f"(exit {proc.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build_kernel_library(name: str) -> Path:
    """Compile one source unless its hash-keyed library exists."""
    return build_kernel_libraries([name])[0]


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build (first use) and load one source's library; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_kernel_library(name)))
            _libs[name] = lib
        return lib


def check_launch(status: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {status}")
