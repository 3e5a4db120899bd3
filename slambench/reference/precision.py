"""Rounding of the reference's intermediates: float64, or bfloat16 for the
control (the reference computed one precision below the float32 that the
configurations state)."""
from __future__ import annotations

import numpy as np
import torch


def exact(x):
    return np.asarray(x, dtype=np.float64)


def bf16(x):
    """Round to the nearest bfloat16 (round to nearest even), kept as
    float64 so that the next operation rounds again."""
    a = np.array(x, dtype=np.float64)
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float64).numpy()



def exact_t(x):
    """The reference's rounding of a float64 tensor: none."""
    return x


def bf16_t(x):
    """The control's: to the nearest bfloat16, kept as float64."""
    return x.to(torch.bfloat16).to(torch.float64)
