"""Device selection for the port's entry points.

Every entry point (``Transformer``, ``generate``, ``PagedDecodeServer``,
``Scheduler``) takes ``device=`` and resolves it here.  The default is
the GPU: a caller who wants the CPU says so, and a machine without a GPU
raises instead of quietly running the CPU path, so no measurement can be
taken on the wrong device by accident.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device passes through.  Raises
    when a CUDA device is asked for (explicitly or by default) and none
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; the port runs on "
                         "'cuda' or 'cpu'")
    return dev


def h2d(array, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a stream sync.

    A plain ``torch.as_tensor(np_array, device="cuda")`` copies from
    pageable memory and synchronises the stream, which would stall the
    host on every decode step.  Pinning first lets the copy queue behind
    the device's work like any other launch; the caching host allocator
    keeps the pinned block alive until the copy has run."""
    t = torch.as_tensor(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
