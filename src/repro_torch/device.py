"""Explicit device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    The default is the card. There is no fallback: asking for CUDA on a
    machine without it raises, and a caller that wants the CPU (the tests)
    says so with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                f"pass device='cpu' to run the plain versions on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
    return dev
