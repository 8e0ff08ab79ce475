"""Host <-> device copies that do not block the host on the card.

A read of a device result starts a non-blocking copy into pinned host
memory and records a CUDA event; the host reads the copy once the event
has completed (usually an event later, when it has long landed).  An
upload of host data goes through pinned memory the same way.  On the
CPU both are plain tensors.
"""

import numpy as np
import torch


def to_pinned(t):
    """Start a non-blocking copy of device tensor ``t`` into pinned host
    memory; returns (host tensor, CUDA event or None on the CPU)."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def landed(host, event):
    """The numpy array of a :func:`to_pinned` copy, once it has landed."""
    if event is not None:
        event.synchronize()
    return host.numpy()


def synchronize(device):
    """Wait for the card (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def upload(device, *arrays):
    """Host numpy arrays -> tensors on ``device``, through pinned memory
    with non-blocking copies on a CUDA device."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out
