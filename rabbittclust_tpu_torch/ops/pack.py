"""Packed sketch planes on the device: the state the MST engine keeps
resident.  The packing itself is the shared ``rabbittclust_tpu.ops.pack``
(numpy); this module only moves it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..host import PackedSketches


@dataclass
class DevicePlanes:
    plane0: torch.Tensor            # (n_pad, W, K) int32 view of uint32
    plane1: Optional[torch.Tensor]  # same, 64-bit hashes only
    sizes: torch.Tensor             # (n_pad,) int32

    @property
    def two_plane(self) -> bool:
        return self.plane1 is not None


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # one pinned host-to-device copy; the caching host allocator keeps
        # the pinned buffer alive until the copy has run
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def planes_to_device(packed: PackedSketches,
                     device: torch.device) -> DevicePlanes:
    """Planes as int32 views (no copy of values: equality is bitwise, so
    the ``0x80000000 | gid`` pad rule stays exact), sizes as int32."""
    return DevicePlanes(
        plane0=_to_device(packed.plane0.view(np.int32), device),
        plane1=None if packed.plane1 is None else
        _to_device(packed.plane1.view(np.int32), device),
        sizes=_to_device(packed.sizes.astype(np.int32), device))
