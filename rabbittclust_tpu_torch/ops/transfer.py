"""Device-to-host pulls that wait on an event, never on the whole stream
(shared by the dense engine, the stream generator and the LP engine)."""

from __future__ import annotations

import numpy as np
import torch


def _host_async(t: torch.Tensor):
    """Start a device-to-host copy into page-locked memory without waiting
    for the rest of the stream; ``_host_wait`` returns the numpy array.  A
    CPU tensor is returned as is."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)  # on t's device's current stream
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _host_wait(pending) -> np.ndarray:
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()
