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


def shard_devices(device="cuda", shards: int | None = None) -> list[str]:
    """The device of each shard of a serving store, by the JAX package's
    rule: ``cuda`` with no index spreads the shards over every visible card,
    one each (the JAX store's ``jax.devices()``), and ``shards`` more than
    the cards cycle them, ``cuda:(i % count)`` (the JAX launcher's
    ``devices[i % len(devs)]``). An explicit ``cuda:N`` or ``cpu`` holds
    every shard, ``shards`` (default 1) of them. Raises, as
    :func:`resolve_device`, where a CUDA device is named and none exists.
    """
    name = str(device)
    resolve_device(name)
    if name == "cuda":
        count = torch.cuda.device_count()
        return [f"cuda:{i % count}" for i in range(shards or count)]
    return [name] * (shards or 1)
