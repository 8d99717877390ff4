"""Mask bit-packing (counterpart of ``rabbittclust_tpu/ops/bitmap.py``
``pack_mask_u8``).  The host decoders (``_decode_packed_mask``) are shared,
through ``host.py``."""

from __future__ import annotations

import torch


def pack_mask_u8(mask: torch.Tensor) -> torch.Tensor:
    """Bit-pack a boolean (..., r, c) mask to (..., r, c // 8) uint8,
    little bit order (the inverse of ``np.unpackbits(bitorder="little")``);
    byte-equal to the JAX version."""
    *lead, c = mask.shape
    bits = mask.reshape(*lead, c // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    return (bits * weights).sum(-1, dtype=torch.int32).to(torch.uint8)
