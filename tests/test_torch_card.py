"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA card (a CUDA kernel has no CPU mode): each takes
the ``card`` fixture, which skips without one. The file imports no JAX, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

Integer tables and queries make every f32 dot exact, so kernel and plain
version must agree bitwise, ties included."""
import numpy as np
import pytest
import torch

from repro_torch.embed_serve import ShardedEmbeddingStore
from repro_torch.embed_serve import quant as qz
from repro_torch.embed_serve import topk as tk
from repro_torch.kernels import sgns


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _int(n, d, seed, lo=-4, hi=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, size=(n, d)).astype(np.float32))


def _same(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_topk_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(11)
    base = _int(6, 128, 12)                    # six distinct rows: ties
    tbl = base[rng.integers(0, 6, size=70_000)].to(card, dtype)
    q = _int(37, 128, 13).to(card)
    before = tk.LAUNCHES["topk_scan_exact"]
    cases = ((1, 70_000), (100, 70_000), (10, 69_997), (512, 300), (50, 40))
    for k, valid in cases:
        _same(tk.topk_mips(tbl, q, k, valid),
              tk.topk_mips_plain(tbl, q, k, valid))
    assert tk.LAUNCHES["topk_scan_exact"] == before + len(cases)


def test_quant_and_gather_kernels_match_plain(card):
    tbl = _int(5000, 128, 8).to(card).bfloat16()
    q = _int(37, 128, 9).to(card)
    q8, sc = qz.quantize_rows(tbl)
    for m, valid in ((40, 5000), (400, 4993)):
        _same(tk.topk_mips_quant(q8, sc, q, m, valid),
              tk.topk_mips_quant_plain(q8, sc, q, m, valid))
    for t in (tbl, tbl.float(), tbl[:, :20].contiguous()):
        idx = torch.randint(0, 5000, (1001,), device=card, dtype=torch.int32)
        assert torch.equal(sgns.gather_rows(t, idx),
                           sgns.gather_rows_plain(t, idx))


def test_store_on_card_matches_cpu(card):
    tbl = _int(301, 32, 14).bfloat16()
    q = _int(11, 32, 15).numpy()
    cpu = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"] * 3,
                                           quant="int8")
    gpu = ShardedEmbeddingStore.from_array(tbl, devices=[card] * 3,
                                           quant="int8")
    for impl in ("exact", "quant"):
        for k in (1, 10, 100):
            want, got = cpu.topk(q, k, impl=impl), gpu.topk(q, k, impl=impl)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    q = torch.zeros((4, 16), device=card)
    with pytest.raises(ValueError, match="dtype"):
        tk.topk_mips(torch.zeros((32, 16), device=card, dtype=torch.float16),
                     q, 3)
    with pytest.raises(ValueError, match="queries"):
        tk.topk_mips(torch.zeros((32, 16), device=card), q.double(), 3)
    with pytest.raises(ValueError, match="d % 8"):
        tk.topk_mips(torch.zeros((32, 12), device=card),
                     torch.zeros((4, 12), device=card), 3)
    with pytest.raises(ValueError, match="idx"):
        sgns.gather_rows(torch.zeros((32, 16), device=card),
                         torch.zeros(3, device=card, dtype=torch.int64))
