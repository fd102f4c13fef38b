"""Checkpoints cross between the JAX package and the port bitwise, in both
directions, and a damaged file is refused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jck
from repro_torch.train import checkpoint as tck


def _tables(seed=0, n=37, d=16):
    rng = np.random.default_rng(seed)
    f32 = rng.normal(0, 0.1, size=(n, d)).astype(np.float32)
    return f32, np.asarray(jnp.asarray(f32).astype(jnp.bfloat16))


def _bits(x):
    """Raw bits of a tensor or array (bf16 as uint16 words)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint8)
    return np.ascontiguousarray(x).view(np.uint8)


def test_jax_checkpoint_loads_in_port_bitwise(tmp_path):
    f32, bf16 = _tables()
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, {"vertex": bf16, "context": f32}, step=7)
    arrays, step = tck.load_arrays(path)
    assert step == 7
    assert arrays["vertex"].dtype == torch.bfloat16
    assert arrays["context"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(arrays["vertex"]), _bits(bf16))
    np.testing.assert_array_equal(_bits(arrays["context"]), _bits(f32))


def test_port_checkpoint_loads_in_jax_bitwise(tmp_path):
    f32, bf16 = _tables(seed=1)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, {"vertex": torch.from_numpy(f32).bfloat16(),
                               "context": torch.from_numpy(f32)}, step=3)
    arrays, step = jck.load_arrays(path)
    assert step == 3
    assert arrays["vertex"].dtype == bf16.dtype      # ml_dtypes bfloat16
    # torch's f32 -> bf16 rounding equals JAX's (round to nearest even)
    np.testing.assert_array_equal(_bits(arrays["vertex"]), _bits(bf16))
    np.testing.assert_array_equal(_bits(arrays["context"]), _bits(f32))


def test_port_roundtrip_nested_and_extra(tmp_path):
    path = str(tmp_path / "nested.npz")
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tck.save_checkpoint(path, {"a": {"b": t, "c": t.bfloat16()}},
                        extra={"cursor": np.asarray([5, 6])})
    arrays, step = tck.load_arrays(path)
    assert step == -1
    assert torch.equal(arrays["a/b"], t)
    assert torch.equal(arrays["a/c"], t.bfloat16())
    assert arrays["cursor"].tolist() == [5, 6]


def test_flipped_byte_raises(tmp_path):
    f32, bf16 = _tables(seed=2)
    path = str(tmp_path / "bad.npz")
    jck.save_checkpoint(path, {"vertex": bf16}, step=1)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    raw = data["vertex"].copy()
    raw.view(np.uint8)[5] ^= 0x10                     # one bit of one row
    data["vertex"] = raw
    np.savez(path, **data)
    with pytest.raises(tck.CheckpointCorrupt, match="checksum mismatch"):
        tck.load_arrays(path)
    # the JAX package refuses it the same way
    with pytest.raises(jck.CheckpointCorrupt, match="checksum mismatch"):
        jck.load_arrays(path)
    tck.load_arrays(path, verify=False)               # opt-out still reads


def test_truncated_file_raises(tmp_path):
    path = tmp_path / "torn.npz"
    tck.save_checkpoint(str(path), {"vertex": torch.ones(4, 4)})
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(tck.CheckpointCorrupt, match="unreadable"):
        tck.load_arrays(str(path))


def test_from_jax_arrays_bitwise():
    f32, bf16 = _tables(seed=3)
    out = tck.from_jax_arrays({"vertex": bf16, "context": f32}, device="cpu")
    assert out["vertex"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out["vertex"]), _bits(bf16))
    np.testing.assert_array_equal(_bits(out["context"]), _bits(f32))


def test_from_jax_arrays_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tck.from_jax_arrays({"vertex": np.zeros((2, 2), np.float32)})
