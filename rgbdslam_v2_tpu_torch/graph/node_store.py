"""Device-resident per-node data: keypoints, descriptors, EMM depth maps.

Port of ``rgbdslam_v2_tpu/graph/node_store.py::NodeStore``. One
preallocated struct of tensors; node i is row i, written in place.

The JAX store also keeps ``emm_zs``, a copy of the depth samples at the
EMM stride, because a strided gather from the full rows is slow on a TPU.
Here the compare reads those samples from ``depth`` directly, so the plane
is not kept (the EMM counts are unchanged).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.types import Keypoints
from ..ops.emm import emm_pool_maps

# emm_pool_maps' encoding of an all-invalid row: f16 lo=+inf | hi=-inf
# (0xFC007C00 as a signed 32-bit word), so an uncommitted row reads as
# unobserved
EMPTY_LOHI = 0xFC007C00 - (1 << 32)


@dataclasses.dataclass
class NodeStore:
    """uv (N, K, 2) f32 | xyz (N, K, 3) f32 | desc (N, K, D) int8, bf16 or
    f32 (D and dtype by the feature family and tpu_descriptor_dtype) |
    kp_valid (N, K) bool | depth (N, h*w) f32 (0 = invalid) |
    emm_lohi (N, h*w) int32 packed pools | color (N, h*w*3) u8."""

    uv: torch.Tensor
    xyz: torch.Tensor
    desc: torch.Tensor
    kp_valid: torch.Tensor
    depth: torch.Tensor
    emm_lohi: torch.Tensor
    color: torch.Tensor

    @classmethod
    def create(cls, n_cap: int, k_cap: int, desc_dim: int, emm_h: int, emm_w: int,
               store_color: bool = True, *, device,
               desc_dtype: torch.dtype = torch.int8) -> "NodeStore":
        color_len = emm_h * emm_w * 3 if store_color else 3
        kw = dict(device=device)
        return cls(
            uv=torch.zeros((n_cap, k_cap, 2), dtype=torch.float32, **kw),
            xyz=torch.zeros((n_cap, k_cap, 3), dtype=torch.float32, **kw),
            desc=torch.zeros((n_cap, k_cap, desc_dim), dtype=desc_dtype, **kw),
            kp_valid=torch.zeros((n_cap, k_cap), dtype=torch.bool, **kw),
            depth=torch.zeros((n_cap, emm_h * emm_w), dtype=torch.float32, **kw),
            emm_lohi=torch.full((n_cap, emm_h * emm_w), EMPTY_LOHI, dtype=torch.int32, **kw),
            color=torch.zeros((n_cap, color_len), dtype=torch.uint8, **kw),
        )

    def insert(self, idx: torch.Tensor, kp: Keypoints, depth_small: torch.Tensor,
               color_small: torch.Tensor) -> None:
        """Write node idx ((1,) long tensor on the store's device) in place;
        the index stays on the device, so a captured step can replay it."""
        self.uv.index_copy_(0, idx, kp.uv[None])
        self.xyz.index_copy_(0, idx, kp.xyz[None])
        self.desc.index_copy_(0, idx, kp.desc[None].to(self.desc.dtype))
        self.kp_valid.index_copy_(0, idx, kp.valid[None])
        self.depth.index_copy_(0, idx, depth_small.reshape(1, -1))
        self.emm_lohi.index_copy_(0, idx, emm_pool_maps(depth_small).reshape(1, -1))
        self.color.index_copy_(0, idx, color_small.reshape(1, -1)[:, : self.color.shape[1]])

    def clear_features(self, idx) -> None:
        """Free feature slots in place (clearFeatureInformation): idx is a
        node id or an index array (the batched clear_non_keyframes path).
        A node id and a long tensor already on the device are cleared
        without waiting for the card."""
        if isinstance(idx, int):
            self.kp_valid[idx].fill_(False)
        else:
            self.kp_valid.index_fill_(
                0, torch.as_tensor(idx, dtype=torch.long, device=self.kp_valid.device).reshape(-1),
                False)
