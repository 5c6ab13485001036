"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a quiet fall back to the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(array: np.ndarray, device) -> torch.Tensor:
    """A fresh host array as a tensor on ``device``.  To the card it goes
    from pinned memory without blocking the host: the copy runs in stream
    order, and the pinned buffer is kept until it has run.  On the CPU the
    tensor shares the array's memory."""
    t = torch.from_numpy(array)
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t
