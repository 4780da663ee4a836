"""Device policy of the port: where its tensors and kernels live.

Every entry point takes ``device=None``, which means ``"cuda"``: the
hand-written kernels are the point of this package, so asking for the
card on a machine without one raises instead of quietly running the
plain PyTorch versions on the CPU.  The CPU path runs only when a caller
asks for it (``device="cpu"``), as the parity tests do.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for ``device`` (``None`` → ``"cuda"``).

    Raises ``RuntimeError`` for a CUDA device when no card is visible, and
    ``ValueError`` for a device type the port has no path for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    return dev
