"""Explicit device selection for the port.  There is no CPU fallback: a run
that asks for the GPU and finds none fails, and CPU runs (the plain torch
versions of the kernels) happen only when a caller passes the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` requires CUDA and returns ``cuda:0``; anything else is taken
    as given (``torch.device("cpu")`` runs the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("--device needs a CUDA GPU and "
                               "torch.cuda.is_available() is false")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but "
                           "torch.cuda.is_available() is false")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
