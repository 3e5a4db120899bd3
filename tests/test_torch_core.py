"""Port parity: core geometry (se3, alignment, noise) against the JAX package,
and the port's import independence from jax.

Inputs come from a numpy seed and go through both packages; floats agree
to rtol 1e-5 (atol 1e-6 for entries near zero: float32 rounding of
different but equivalent operation orders).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import alignment as jal, noise as jno, se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu_torch.core import alignment as tal, noise as tno, se3 as tse3  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol, atol=atol)


def _twists(n=64, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-6  # near-zero rotations take the series branches
    return xi


@pytest.mark.parametrize("fn", ["exp_se3", "log_se3", "inv", "quat"])
def test_se3_matches_jax(fn):
    xi = _twists()
    T = np.array(jse3.exp_se3(jnp.asarray(xi)))
    if fn == "exp_se3":
        _close(jse3.exp_se3(jnp.asarray(xi)), tse3.exp_se3(torch.from_numpy(xi)))
    elif fn == "log_se3":
        _close(jse3.log_se3(jnp.asarray(T)), tse3.log_se3(torch.from_numpy(T)), atol=1e-5)
    elif fn == "inv":
        _close(jse3.inv(jnp.asarray(T)), tse3.inv(torch.from_numpy(T)))
    else:
        R = T[:, :3, :3]
        _close(jse3.rot_to_quat(jnp.asarray(R)), tse3.rot_to_quat(torch.from_numpy(R)))
        q = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
        _close(jse3.quat_to_rot(jnp.asarray(q)), tse3.quat_to_rot(torch.from_numpy(q)))


def _correspondences(seed=0, batch=(16,), n=40):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, batch + (n, 3)).astype(np.float32) + np.float32([0, 0, 2])
    T = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.2, batch + (6,)).astype(np.float32))))
    dst = (src @ np.swapaxes(T[..., :3, :3], -1, -2) + T[..., None, :3, 3]
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, batch + (n,)).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("fit", ["weighted_kabsch", "weighted_kabsch_quat"])
def test_alignment_matches_jax(fit):
    src, dst, w = _correspondences()
    a = getattr(jal, fit)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    b = getattr(tal, fit)(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    _close(a, b, atol=1e-5)


def test_point_covariance_diag_matches_jax():
    z = np.random.default_rng(3).uniform(0.3, 8.0, 500).astype(np.float32)
    _close(jno.point_covariance_diag(jnp.asarray(z), 525.0, 520.0),
           tno.point_covariance_diag(torch.from_numpy(z), 525.0, 520.0), atol=0)


def test_port_imports_without_jax():
    """Every module of the port imports with jax blocked."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import rgbdslam_v2_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert not any(k.startswith('rgbdslam_v2_tpu.') for k in sys.modules)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
