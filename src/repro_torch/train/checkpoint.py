"""Flat-npz checkpoints in the JAX package's format (``repro/train/checkpoint.py``).

A checkpoint is one ``.npz`` whose entries are:

* one array per table, keyed by its path (``"vertex"``, ``"a/b"``);
* ``__step__``, when a step was given;
* ``__dtype__:<key>`` naming the dtype of entries numpy cannot name
  (``"bfloat16"``): their bytes are stored raw as ``|V2``;
* ``__crc__:<key>``, the (crc32, byte length) of every entry as stored;
* ``__manifest__``, the sorted list of every non-CRC key.

Files written here load bitwise in the JAX package and the other way round.
bf16 is decoded without ``ml_dtypes``: the raw 2-byte words are viewed as
int16 and then as ``torch.bfloat16``, which moves no bits.
"""
from __future__ import annotations

import os
import zipfile
import zlib

import numpy as np
import torch

_DTYPE_PREFIX = "__dtype__:"
_CRC_PREFIX = "__crc__:"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed its manifest/checksum verification."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"checkpoint {path} corrupt: {reason}")


def _crc(arr: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(arr).tobytes()
    return np.asarray([zlib.crc32(b), len(b)], dtype=np.int64)


def _is_bf16(arr: np.ndarray) -> bool:
    """An ml_dtypes bfloat16 array, or raw 2-byte void words."""
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                            and arr.dtype.itemsize == 2)


def _to_stored(value) -> tuple[np.ndarray, str | None]:
    """A tensor or array as the npz stores it, plus the dtype name to
    record when numpy cannot name it (bf16 -> raw ``|V2`` bytes)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy()
            return raw.view(np.dtype("V2")), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(value)
    if _is_bf16(arr):
        return np.ascontiguousarray(arr).view(np.dtype("V2")), "bfloat16"
    return arr, None


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def save_checkpoint(path: str, tree: dict, *, step: int | None = None,
                    extra: dict | None = None) -> None:
    """Atomically write a (nested) dict of tensors or arrays, plus optional
    ``extra`` arrays, with a per-entry checksum manifest."""
    arrs = {}
    for key, val in {**_flatten(tree), **(extra or {})}.items():
        arr, dtype_name = _to_stored(val)
        arrs[key] = arr
        if dtype_name is not None:
            arrs[_DTYPE_PREFIX + key] = np.asarray(dtype_name)
    if step is not None:
        arrs["__step__"] = np.asarray(step)
    for key, arr in list(arrs.items()):
        arrs[_CRC_PREFIX + key] = _crc(arr)
    arrs["__manifest__"] = np.asarray(sorted(k for k in arrs
                                             if not k.startswith(_CRC_PREFIX)))
    tmp = path + ".tmp"
    np.savez(tmp, **arrs)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def numpy_to_tensor(arr: np.ndarray,
                    dtype_name: str | None = None) -> torch.Tensor:
    """A numpy array as a CPU tensor, bitwise; bf16 (ml_dtypes, or raw
    ``|V2`` words) becomes ``torch.bfloat16`` without ml_dtypes."""
    # torch shares the array's memory: copy read-only arrays (JAX's)
    arr = np.ascontiguousarray(arr) if arr.flags.writeable else arr.copy()
    if dtype_name == "bfloat16" or _is_bf16(arr):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype_name is not None:
        raise ValueError(f"unsupported stored dtype {dtype_name!r}")
    return torch.from_numpy(arr)


def load_arrays(path: str, *, verify: bool = True):
    """``(key -> CPU tensor, step)`` of a checkpoint.

    ``verify`` (default) checks the manifest and every entry's checksum on
    the bytes as stored, before any view-cast, and raises
    :class:`CheckpointCorrupt` on a mismatch. Checkpoints without a
    manifest load unverified, as in the JAX package.
    """
    try:
        with np.load(path) as f:
            data = {k: f[k] for k in f.files}
    except (ValueError, EOFError, OSError, zipfile.BadZipFile) as e:
        raise CheckpointCorrupt(path, f"unreadable npz: {e}") from e
    crcs = {k[len(_CRC_PREFIX):]: data.pop(k)
            for k in list(data) if k.startswith(_CRC_PREFIX)}
    manifest = data.pop("__manifest__", None)
    if verify and manifest is not None:
        want = set(str(k) for k in manifest.tolist())
        have = set(data)
        if want != have:
            missing, stray = sorted(want - have), sorted(have - want)
            raise CheckpointCorrupt(
                path, f"manifest mismatch: missing={missing} stray={stray}")
        for key, arr in data.items():
            got = _crc(arr)
            exp = crcs.get(key)
            if exp is None or not np.array_equal(got, np.asarray(exp)):
                raise CheckpointCorrupt(
                    path, f"checksum mismatch for {key!r} "
                          f"(got {got.tolist()}, want "
                          f"{None if exp is None else np.asarray(exp).tolist()})")
    step = int(data.pop("__step__", -1))
    names = {k[len(_DTYPE_PREFIX):]: str(data.pop(k).item())
             for k in list(data) if k.startswith(_DTYPE_PREFIX)}
    return {k: numpy_to_tensor(v, names.get(k)) for k, v in data.items()}, step


def from_jax_arrays(arrays: dict, device="cuda") -> dict:
    """The JAX package's numpy arrays (f32, or ml_dtypes bf16) as the
    port's tensors on ``device``, bitwise. This is how weights cross from
    the reference to the port without a file in between."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return {k: numpy_to_tensor(np.asarray(v), None).to(dev)
            for k, v in arrays.items()}
