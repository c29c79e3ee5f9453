"""Where the port's tensors live.

Every entry point that creates tensors takes a ``device``. ``None``
means the CUDA card; the CPU runs only when the caller asks for it
(``device="cpu"``), and then the label joins run their plain PyTorch
versions instead of the CUDA kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` → ``torch.device("cuda")``; raises when a CUDA device is
    asked for and none exists, so nothing carries on on the CPU unless
    the caller passed ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
