"""Serving failures, from the JAX package's ``runtime/errors.py``.

The port imports nothing of the JAX package, so it keeps its own copy of
the one class its serving path raises. The rest of that vocabulary (fault
injection, sample-store stalls, transport and corrupt-episode errors, the
``Overloaded`` of admission control) comes with the slices that raise it.
"""
from __future__ import annotations


class DeadlineExceeded(RuntimeError):
    """A serving request's deadline passed before it was served."""
