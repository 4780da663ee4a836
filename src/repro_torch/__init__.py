"""RT-RkNN in PyTorch and CUDA: the port of the JAX package ``repro``.

Module for module this package mirrors ``repro``'s layout; the JAX
package stays the reference the port is tested against.  Host code (the
filter phase: pruning, occluders, scene packing) is numpy carried over
verbatim; the verify phase runs on torch tensors, through hand-written
CUDA kernels (``repro_torch/csrc``) on the card and their plain PyTorch
versions on the CPU.  See :mod:`repro_torch.device` for the device rule.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
