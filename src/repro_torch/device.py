"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
There is no silent fallback: without a card, a call that did not ask for
the CPU raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` if no card is present)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not available")
    return dev


def as_tensor(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy array / tensor -> tensor on ``device`` (no copy when already there)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(a))
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def host_array(a):
    """Tensor (on any device) or array-like -> numpy array (no copy when already one)."""
    import numpy as np

    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
