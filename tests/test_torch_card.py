"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA card (a CUDA kernel has no CPU mode): each takes
the ``card`` fixture, which skips without one. The file imports no JAX, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

For the scans, integer tables and queries make every f32 dot exact, so
kernel and plain version must agree bitwise, ties included. The gathers and
scatter-adds have one defined order, so they agree bitwise too, and the
blocked kernels with their row-wise references (the rowwise top-k
with the scan even on continuous rows). The SGNS kernels sum in
another order than their plain versions, so they are held to the JAX
kernel tests' tolerances (bf16 tables also to two bf16 steps), and to
themselves bitwise."""
import numpy as np
import pytest
import torch

from repro_torch.embed_serve import ShardedEmbeddingStore
from repro_torch.embed_serve import quant as qz
from repro_torch.embed_serve import topk as tk
from repro_torch.kernels import ops, sgns


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_topk_kernel_matches_plain_on_continuous_rows(card, dtype):
    """#1's filter and exact rescore on a continuous 200,000-row table, at
    one query, a launcher batch and a full serving batch: bitwise the
    rowwise kernel (#4), the other fmaf chain, and the plain version. The
    plain version scores the queries padded to a batch of 256, where
    cuBLAS's GEMM sums each dot in index order (for one query its GEMV
    sums in another order, which can swap near-ties). At k = 10 the filter
    drops most pairs (a warp's list sees a few hundred rows here, so its
    first rows all pass)."""
    g = torch.Generator(device=card).manual_seed(51)
    tbl = (0.1 * torch.randn((200_000, 128), generator=g, device=card)
           ).to(dtype)
    tbl[150_000:150_300] = tbl[:300]           # exact ties on real data
    for Q in (1, 8, 256):
        rows = torch.randint(0, 200_000, (Q,), generator=g, device=card)
        q = tbl[rows].float() + 0.05 * torch.randn((Q, 128), generator=g,
                                                   device=card)
        n = torch.zeros(1, dtype=torch.int64, device=card)
        for k, valid in ((10, 200_000), (100, 199_999)):
            got = tk.topk_mips(tbl, q, k, valid, survivors=n)
            _same(got, tk.topk_mips_rowwise(tbl, q, k, valid))
            qpad = torch.cat([q, q.new_zeros((256 - Q, 128))])
            _same(got, [t[:Q] for t in tk.topk_mips_plain(tbl, qpad, k,
                                                          valid)])
            assert 0 < n.item() <= Q * valid
            if k == 10:
                assert n.item() < 0.5 * Q * valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_topk_filter_scores_within_a_quarter_of_the_bound(card, dtype):
    """The tensor cores' approximate scores (the test-only export) differ
    from the exact scores by at most eps / 4: random rows and queries, and
    rows built against each term of the bound (cancellation, a wide range
    of magnitudes, rows along the queries' bf16 rounding error, f32 entries
    halfway between bf16 values)."""
    g = torch.Generator(device=card).manual_seed(52)
    q = torch.randn((64, 128), generator=g, device=card)
    q[0] = (2.0 ** torch.randint(-4, 4, (128,), generator=g, device=card)
            ) * (1 + 2.0 ** -8 - 2.0 ** -20)          # the worst split
    err = q - q.bfloat16().float()
    alt = torch.where(torch.arange(128, device=card) % 2 == 0, 1.0, -1.0)
    sign = torch.randint(0, 2, (128,), generator=g, device=card) * 2.0 - 1
    mid = (2.0 ** torch.randint(-6, 6, (128,), generator=g, device=card)
           ) * (1 + 2.0 ** -8 - 2.0 ** -22)
    tbl = torch.cat([
        torch.randn((20_000, 128), generator=g, device=card),
        (alt * 3e3).expand(64, 128),
        alt * 1e4 * torch.sign(q),
        sign * 2.0 ** (60 * torch.rand((64, 128), generator=g,
                                       device=card) - 30),
        torch.sign(err) * 7.0,
        5.0 * err / err.norm(dim=1, keepdim=True).clamp_min(1e-30),
        (mid * sign).expand(64, 128), mid * torch.sign(q),
    ]).to(dtype).contiguous()
    a, eps = tk.topk_filter_bounds(tbl, q)
    exact = q @ tbl.float().T
    torch.cuda.synchronize()
    assert a.shape == eps.shape == exact.shape
    assert bool(((a - exact).abs() <= eps / 4).all())
    # the export's bound is the plain formula's
    _, want = tk.topk_filter_bounds_plain(tbl, q)
    torch.testing.assert_close(eps, want, rtol=1e-4, atol=0)


def test_quant_and_gather_kernels_match_plain(card):
    tbl = _int(5000, 128, 8).to(card).bfloat16()
    q = _int(37, 128, 9).to(card)
    q8, sc = qz.quantize_rows(tbl)
    for m, valid in ((40, 5000), (400, 4993)):
        _same(tk.topk_mips_quant(q8, sc, q, m, valid),
              tk.topk_mips_quant_plain(q8, sc, q, m, valid))
    # d % 16 == 8: the int8 rows stage by 8-byte copies
    q8, sc = qz.quantize_rows(_int(1000, 40, 10).to(card))
    q = _int(9, 40, 11).to(card)
    _same(tk.topk_mips_quant(q8, sc, q, 40, 997),
          tk.topk_mips_quant_plain(q8, sc, q, 40, 997))
    for t in (tbl, tbl.float(), tbl[:, :20].contiguous()):
        idx = torch.randint(0, 5000, (1001,), device=card, dtype=torch.int32)
        assert torch.equal(sgns.gather_rows(t, idx),
                           sgns.gather_rows_plain(t, idx))
    # #3 at every vector width (rows of 16-, 8-, 4-, 2- and 1-byte
    # multiples), from bases 1 and 2 elements into a buffer, rows wider
    # than 32 vectors, and past one wave of blocks (the grid striding);
    # bitwise plain and the row-wise reference (#8)
    rng = np.random.default_rng(12)
    before = sgns.LAUNCHES["gather_rows"]
    cases = ((torch.float32, 128, 1001), (torch.float32, 6, 333),
             (torch.float32, 3, 333), (torch.bfloat16, 7, 333),
             (torch.bfloat16, 1, 333), (torch.int8, 12, 333),
             (torch.int8, 7, 333), (torch.uint8, 128, 1001),
             (torch.float32, 1026, 77), (torch.bfloat16, 1, 3_000_000))
    for dtype, d, B in cases:
        for offset in (0, 1, 2):
            flat = torch.from_numpy(rng.integers(
                -100, 100, offset + 300 * d).astype(np.float32)).to(card,
                                                                    dtype)
            t = flat[offset:].view(300, d)
            idx = torch.from_numpy(rng.integers(0, 300, B).astype(
                np.int32)).to(card)
            got = sgns.gather_rows(t, idx)
            assert torch.equal(got, sgns.gather_rows_plain(t, idx))
            assert torch.equal(got, sgns.gather_rows_rowwise(t, idx))
    assert sgns.LAUNCHES["gather_rows"] == before + 3 * len(cases)


def test_quant_kernel_matches_plain_on_continuous_rows(card):
    """#2, the filter kernel on int8 rows: a continuous 200,000-row table
    quantized as the store does it, at one query, a launcher batch and a
    full serving batch, m = 40 (the seeded case) and m = 400, bitwise the
    plain version (the queries padded to a batch of 256 for it, as in #1's
    test), and the filter dropping most pairs at m = 40."""
    g = torch.Generator(device=card).manual_seed(53)
    tbl = 0.1 * torch.randn((200_000, 128), generator=g, device=card)
    tbl[150_000:150_300] = tbl[:300]
    q8, sc = qz.quantize_rows(tbl)
    before = tk.LAUNCHES["topk_scan_int8"]
    for Q in (1, 8, 256):
        rows = torch.randint(0, 200_000, (Q,), generator=g, device=card)
        q = tbl[rows] + 0.05 * torch.randn((Q, 128), generator=g, device=card)
        qpad = torch.cat([q, q.new_zeros((256 - Q, 128))])
        n = torch.zeros(1, dtype=torch.int64, device=card)
        for m, valid in ((40, 200_000), (400, 199_993)):
            got = tk.topk_mips_quant(q8, sc, q, m, valid, survivors=n)
            _same(got, [t[:Q] for t in tk.topk_mips_quant_plain(
                q8, sc, qpad, m, valid)])
            assert 0 < n.item() <= Q * valid
            if m == 40:
                assert n.item() < 0.5 * Q * valid
    assert tk.LAUNCHES["topk_scan_int8"] == before + 6


def test_quant_filter_scores_within_a_quarter_of_the_bound(card):
    """The export of #2's tensor-core scores on int8 rows (unscaled) within
    eps / 4 of the exact chain: random rows and +-127 rows along the
    queries' bf16 rounding error, against their signs, alternating."""
    g = torch.Generator(device=card).manual_seed(54)
    q = torch.randn((64, 128), generator=g, device=card)
    q[0] = (2.0 ** torch.randint(-4, 4, (128,), generator=g, device=card)
            ) * (1 + 2.0 ** -8 - 2.0 ** -20)
    err = q - q.bfloat16().float()
    alt = torch.where(torch.arange(128, device=card) % 2 == 0, 1.0, -1.0)
    tbl = torch.cat([
        torch.randint(-127, 128, (20_000, 128), generator=g, device=card),
        127 * torch.sign(err), -127 * torch.sign(err),
        (127 * alt).expand(64, 128), 127 * alt * torch.sign(q),
        torch.zeros((64, 128), device=card),
    ]).to(torch.int8).contiguous()
    a, eps = tk.topk_filter_bounds(tbl, q)
    exact = q @ tbl.float().T
    torch.cuda.synchronize()
    assert bool(((a - exact).abs() <= eps / 4).all())
    _, want = tk.topk_filter_bounds_plain(tbl, q)
    torch.testing.assert_close(eps, want, rtol=1e-4, atol=0)


def test_store_on_card_matches_cpu(card):
    tbl = _int(301, 32, 14).bfloat16()
    q = _int(11, 32, 15).numpy()
    cpu = ShardedEmbeddingStore.from_array(tbl, devices=["cpu"] * 3,
                                           quant="int8")
    gpu = ShardedEmbeddingStore.from_array(tbl, devices=[card] * 3,
                                           quant="int8")
    for impl in ("pallas", "quant"):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rowwise_kernel_matches_plain(card, dtype):
    """#4 on integer tables: six distinct rows (ties at every rank), a
    ragged last tile, valid < N, k > valid, Q not a multiple of 32."""
    rng = np.random.default_rng(21)
    base = _int(6, 128, 22)
    tbl = base[rng.integers(0, 6, size=5_003)].to(card, dtype)
    q = _int(37, 128, 23).to(card)
    before = tk.LAUNCHES["topk_rowwise"]
    cases = ((1, 5_003), (100, 5_003), (10, 4_990), (64, 40), (10, 1))
    for k, valid in cases:
        _same(tk.topk_mips_rowwise(tbl, q, k, valid),
              tk.topk_mips_rowwise_plain(tbl, q, k, valid))
    assert tk.LAUNCHES["topk_rowwise"] == before + len(cases)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rowwise_kernel_matches_scan_on_continuous_rows(card, dtype):
    """#4 and #1 take one fmaf chain over d in index order, so they agree
    bit for bit on continuous rows too; repeated rows make exact ties."""
    g = torch.Generator(device=card).manual_seed(24)
    tbl = torch.randn((20_000, 128), generator=g, device=card).to(dtype)
    tbl[1_000:1_500] = tbl[:500]
    q = torch.randn((70, 128), generator=g, device=card)
    for k, valid in ((10, 20_000), (128, 20_000), (16, 19_993)):
        _same(tk.topk_mips_rowwise(tbl, q, k, valid),
              tk.topk_mips(tbl, q, k, valid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rowwise_kernel_over_several_chunks(card, dtype, monkeypatch):
    """#4 with a small score scratch, so the rows take many chunks: six
    distinct integer rows tie at the k-th key inside chunks and across
    their edges, bitwise against plain and against the scan (#1)."""
    rng = np.random.default_rng(31)
    base = _int(6, 128, 32)
    tbl = base[rng.integers(0, 6, size=9_001)].to(card, dtype)
    tbl[1_023:1_026] = tbl[0]         # one row's ties around a chunk edge
    q = _int(37, 128, 33).to(card)
    before = tk.LAUNCHES["topk_rowwise"]
    cases = ((10, 9_001, 4 * 37 * 1_024), (100, 8_999, 4 * 37 * 1_024),
             (1, 9_001, 4 * 37 * 128), (512, 3_000, 4 * 37 * 256),
             (7, 9_001, 4 * 37 * 4_096))
    for k, valid, scratch in cases:
        monkeypatch.setattr(tk, "ROWWISE_SCRATCH_BYTES", scratch)
        assert tk.plan_topk_rowwise(37, 128, k, valid).chunks > 1
        got = tk.topk_mips_rowwise(tbl, q, k, valid)
        _same(got, tk.topk_mips_rowwise_plain(tbl, q, k, valid))
        _same(got, tk.topk_mips(tbl, q, k, valid))
    assert tk.LAUNCHES["topk_rowwise"] == before + len(cases)


def test_tiered_and_degraded_store_on_card_match_cpu(card):
    """The tiered route (CUDA scan of the hot rows, int8 scan, gather and
    rescore of the cold ones) and a 3-shard degraded store, each shard on
    its own stream, give the CPU store's answers."""
    from repro_torch.runtime import inject

    tbl = _int(3001, 128, 25).bfloat16()
    q = _int(64, 128, 26).numpy()
    counts = np.random.default_rng(27).integers(0, 3, 3001)
    stores = [ShardedEmbeddingStore.from_array(tbl, devices=[dev] * 3,
                                               quant="int8")
              for dev in ("cpu", card)]
    for s in stores:
        s.enable_hot_tier(300, counts=counts)
    for k in (1, 10, 100):
        want, got = (s.topk(q, k, impl="tiered") for s in stores)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert stores[0].hot_tier_stats() == stores[1].hot_tier_stats()
    for impl in ("pallas", "rowwise", "quant", "tiered"):
        outs = []
        for s in stores:
            s.topk(q, 10, impl=impl, shard_timeout_s=None)
            with inject("serve.shard:delay:key=1:delay=1.0:times=inf"):
                outs.append(s.topk(q, 10, impl=impl, shard_timeout_s=0.5,
                                   return_meta=True))
        (wv, wi, wm), (gv, gi, gm) = outs
        assert gm.failed_shards == wm.failed_shards == (1,)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
    # the timed-out shard tasks wake after their 1 s delay and still scan and
    # gather: let them end here, so their launches land in no later test
    for s in stores:
        s._pool.shutdown(wait=True)


def test_rowwise_wrapper_raises_on_what_the_kernel_does_not_take(card):
    q = torch.zeros((4, 16), device=card)
    with pytest.raises(ValueError, match="dtype"):
        tk.topk_mips_rowwise(torch.zeros((32, 16), device=card,
                                         dtype=torch.int8), q, 3)
    with pytest.raises(ValueError, match="d % 8"):
        tk.topk_mips_rowwise(torch.zeros((32, 12), device=card),
                             torch.zeros((4, 12), device=card), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tk.topk_mips_rowwise(torch.zeros((16, 32), device=card).T, q, 3)
    with pytest.raises(ValueError, match="shared memory"):
        tk.topk_mips_rowwise(torch.zeros((32, 16), device=card), q, 5000)
    with pytest.raises(ValueError, match="valid"):
        tk.topk_mips_rowwise(torch.zeros((32, 16), device=card), q, 3, 0)


SGNS_TOL = {torch.float32: (2e-4, 1e-6), torch.bfloat16: (3e-2, 3e-3)}


def _sgns_inputs(card, dtype, Nv=70, Nc=90, B=64, S=8, d=64, seed=60,
                 case="nodup"):
    """Tables, indices and mask on the card from a numpy seed; ``case``:
    nodup, dup (vertex 3 and context 5 repeat, a negative hits context 5),
    odd (row 0 a real target of an odd B) or same (one index per table)."""
    rng = np.random.default_rng(seed)
    vert = torch.from_numpy(rng.normal(0, 0.1, (Nv, d)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(0, 0.1, (Nc, d)).astype(np.float32))
    iv = rng.integers(0, Nv, B).astype(np.int32)
    ic = rng.integers(0, Nc, B).astype(np.int32)
    inn = rng.integers(0, Nc, S).astype(np.int32)
    mask = (rng.random(B) > 0.15).astype(np.float32)
    if case == "dup":
        iv[::3], ic[::4], inn[0] = 3, 5, 5
    elif case == "odd":
        iv[0] = 0
    elif case == "same":
        iv[:], ic[:], inn[:], mask[:] = 7, 9, 9, 1.0
    idx = [torch.from_numpy(a).to(card) for a in (iv, ic, inn)]
    # the mask in the tables' dtype, as the trainer passes it
    return (vert.to(card, dtype), ctx.to(card, dtype), *idx,
            torch.from_numpy(mask).to(card, dtype))


def _bf16_step(x):
    """The spacing of bf16 values at the magnitude of each element of x."""
    s = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x == 0, torch.zeros_like(x), s)


def _within_bf16_steps(got, want, before):
    """A bf16 table updated by the kernel against the plain version's: the
    two sum each row's gradients in another order, so their bf16 updates
    may round one step apart, and the new rows one step apart (two across
    a power of two). A dropped or doubled update moves a row by more."""
    got, want, before = got.float(), want.float(), before.float()
    tol = 2 * _bf16_step(want) + _bf16_step(want - before)
    assert ((got - want).abs() <= tol).all()


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,B,d", [("nodup", 64, 64), ("dup", 64, 64),
                                      ("odd", 37, 32), ("dup", 256, 128),
                                      ("same", 128, 32)])
def test_sgns_update_kernel_matches_plain(card, dtype, case, B, d):
    x = _sgns_inputs(card, dtype, B=B, d=d, case=case)
    rtol, atol = SGNS_TOL[dtype]
    if case == "same" and dtype == torch.float32:
        rtol, atol = 1e-3, 1e-5      # a 128-term f32 sum reassociated
    before = sgns.LAUNCHES["sgns_fused_update"]
    outs = []
    for _ in range(2):               # twice from the same tables
        vert, ctx = x[0].clone(), x[1].clone()
        outs.append(sgns.sgns_fused_update(vert, ctx, *x[2:], 0.05))
    torch.cuda.synchronize()
    assert sgns.LAUNCHES["sgns_fused_update"] == before + 2
    for a, b in zip(*outs):          # deterministic: bitwise repeatable
        assert torch.equal(a, b)
    vp, cp, lp = sgns.sgns_fused_update_plain(x[0].clone(), x[1].clone(),
                                              *x[2:], 0.05)
    vk, ck, lk = outs[0]
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    _close(vk, vp, rtol, atol)
    _close(ck, cp, rtol, atol)
    if dtype == torch.bfloat16:
        _within_bf16_steps(vk, vp, x[0])
        _within_bf16_steps(ck, cp, x[1])
    assert not torch.equal(vk, x[0])          # the update happened


def _device_kernels(fn):
    """The names of the device kernels one call of ``fn`` launches (after a
    warm-up call; the profiler may drop a session's first kernels, so an
    empty session is tried again)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        if names:
            return names
    return names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sgns_update_kernel_with_a_hub_run(card, dtype):
    """#7 with one id at 200 of the vertex positions and 100 of the
    context ones (a hub row's run, loaded AHEAD positions at a time): one
    device kernel per call, bitwise repeatable, within the tolerances of
    plain."""
    x = list(_sgns_inputs(card, dtype, Nv=300, Nc=300, B=256, S=5, d=128,
                          seed=61))
    rng = np.random.default_rng(62)
    iv, ic = x[2].cpu().numpy(), x[3].cpu().numpy()
    iv[rng.choice(256, 200, replace=False)] = 17
    ic[rng.choice(256, 100, replace=False)] = 23
    x[2], x[3] = (torch.from_numpy(a).to(card) for a in (iv, ic))
    x[4][1] = 23                                 # a negative in the run
    outs = []
    for _ in range(2):
        vert, ctx = x[0].clone(), x[1].clone()
        outs.append(sgns.sgns_fused_update(vert, ctx, *x[2:], 0.05))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    vp, cp, lp = sgns.sgns_fused_update_plain(x[0].clone(), x[1].clone(),
                                              *x[2:], 0.05)
    rtol, atol = SGNS_TOL[dtype]
    torch.testing.assert_close(outs[0][2], lp, rtol=1e-4, atol=0)
    _close(outs[0][0], vp, rtol, atol)
    _close(outs[0][1], cp, rtol, atol)
    if dtype == torch.bfloat16:
        _within_bf16_steps(outs[0][0], vp, x[0])
        _within_bf16_steps(outs[0][1], cp, x[1])
    assert not torch.equal(outs[0][0][17], x[0][17])
    vert, ctx = x[0].clone(), x[1].clone()
    names = _device_kernels(
        lambda: sgns.sgns_fused_update(vert, ctx, *x[2:], 0.05))
    assert len(names) == 1 and "sgns_update_fused" in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,B,S,d", [("nodup", 64, 8, 64),
                                        ("dup", 64, 8, 64),
                                        ("odd", 37, 4, 32),
                                        ("dup", 256, 5, 128),
                                        ("odd", 1000, 1, 128),
                                        ("dup", 64, 300, 128)])
def test_sgns_fused_grads_kernel_matches_plain(card, dtype, case, B, S, d):
    """#6 against plain: a ragged last block, one negative, B past 8 rows
    a block on 132 SMs, and 300 negatives (most of a block's shared
    memory); the mask in the tables' dtype."""
    x = _sgns_inputs(card, dtype, B=B, S=S, d=d, seed=40, case=case)
    got = sgns.sgns_fused_grads(*x)
    again = sgns.sgns_fused_grads(*x)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = sgns.sgns_fused_grads_plain(*x)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    rtol, atol = (1e-4, 1e-6) if dtype == torch.float32 else SGNS_TOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == dtype
        _close(g, w, rtol, atol)


def test_sgns_wrappers_raise_on_what_the_kernels_do_not_take(card):
    vert, ctx, iv, ic, inn, mask = _sgns_inputs(card, torch.float32)
    with pytest.raises(ValueError, match="overlap"):
        sgns.sgns_fused_update(vert, vert, iv, ic, inn, mask, 0.05)
    both = torch.zeros((160, 64), device=card)
    with pytest.raises(ValueError, match="overlap"):
        sgns.sgns_fused_update(both[:100], both[60:], iv, ic, inn, mask, 0.05)
    with pytest.raises(ValueError, match="idx_v"):
        sgns.sgns_fused_update(vert, ctx, iv.long(), ic, inn, mask, 0.05)
    with pytest.raises(ValueError, match="idx_n"):
        sgns.sgns_fused_grads(vert, ctx, iv, ic, inn.cpu(), mask)
    with pytest.raises(ValueError, match="dtype"):
        sgns.sgns_fused_update(vert.half(), ctx.half(), iv, ic, inn,
                               mask, 0.05)
    with pytest.raises(ValueError, match="mask"):
        sgns.sgns_fused_grads(vert, ctx, iv, ic, inn, mask.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,B,S,d", [("nodup", 64, 8, 64),
                                        ("odd", 37, 4, 32),
                                        ("dup", 256, 5, 128),
                                        ("odd", 1000, 1, 128)])
def test_sgns_grads_kernel_matches_plain(card, dtype, case, B, S, d):
    vert, ctx, iv, ic, inn, mask = _sgns_inputs(card, dtype, B=B, S=S, d=d,
                                                case=case)
    x = (vert[iv.long()], ctx[ic.long()], ctx[inn.long()])
    before = sgns.LAUNCHES["sgns_grads"]
    for m in (mask, mask.float()):
        got = sgns.sgns_grads(*x, m)
        again = sgns.sgns_grads(*x, m)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        want = sgns.sgns_grads_plain(*x, m)
        torch.testing.assert_close(got[0], want[0], rtol=3e-5, atol=3e-5)
        rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else SGNS_TOL[dtype]
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == dtype and g.shape == w.shape
            _close(g, w, rtol, atol)
    assert sgns.LAUNCHES["sgns_grads"] == before + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sgns_grads_and_fused_grads_are_one_launch(card, dtype):
    """#5 and #6 are each one cooperative kernel per call at the trainer's
    minibatch, bitwise repeatable, and #6 is #5 on the rows it gathers,
    bitwise (one kernel, the same rows)."""
    vert, ctx, iv, ic, inn, mask = _sgns_inputs(card, dtype, B=256, S=5,
                                                d=128, case="dup")
    x = (vert[iv.long()], ctx[ic.long()], ctx[inn.long()])
    for fn in (lambda: sgns.sgns_grads(*x, mask),
               lambda: sgns.sgns_fused_grads(vert, ctx, iv, ic, inn, mask)):
        names = _device_kernels(fn)
        assert len(names) == 1 and "sgns_grads_coop" in names[0], names
        runs = [fn() for _ in range(3)]
        torch.cuda.synchronize()
        for run in runs[1:]:
            for a, b in zip(runs[0], run):
                assert torch.equal(a, b)
    for case, B, S, d in (("dup", 256, 5, 128), ("odd", 37, 4, 32),
                          ("same", 128, 8, 32)):
        vert, ctx, iv, ic, inn, mask = _sgns_inputs(card, dtype, B=B, S=S,
                                                    d=d, case=case)
        got = sgns.sgns_fused_grads(vert, ctx, iv, ic, inn, mask)
        want = sgns.sgns_grads(vert[iv.long()], ctx[ic.long()],
                               ctx[inn.long()], mask)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sgns_grads_kernels_take_any_B(card, dtype):
    """#5 and #6 past one 8-row tile a block on every SM (B = 40,001: 5,001
    tiles, each block taking about 38): one kernel per call, bitwise
    repeatable, #6 bitwise #5 on the gathered rows, and both against
    plain. dn sums 40,001 rows in f32, so in f32 it is held to the exact
    sum (f64) within the recursive-summation bound, n u times the sum of
    the terms' magnitudes, n the adds of its three levels (a tile's 8
    rows, a block's tiles, the blocks in order) plus d for each term's own
    error (g_neg behind a d-term dot, whose magnitudes sum below 1 here);
    the rest within 1e-4 / 1e-6 (f32) and SGNS_TOL (bf16) of plain."""
    B, S, d = 40_001, 5, 128
    vert, ctx, iv, ic, inn, mask = _sgns_inputs(card, dtype, B=B, S=S, d=d,
                                                case="dup")
    x = (vert[iv.long()], ctx[ic.long()], ctx[inn.long()])
    plan = sgns.plan_sgns_grads(B, S, d, sm_count=sgns._sm_count(vert.device))
    assert plan.blocks < plan.tiles
    fused = lambda: sgns.sgns_fused_grads(vert, ctx, iv, ic, inn, mask)
    for fn in (lambda: sgns.sgns_grads(*x, mask), fused):
        names = _device_kernels(fn)
        assert len(names) == 1 and "sgns_grads_coop" in names[0], names
    got, again, five = fused(), fused(), sgns.sgns_grads(*x, mask)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, five):
        assert torch.equal(a, b) and torch.equal(a, c)
    want = sgns.sgns_grads_plain(*x, mask)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    rtol, atol = (1e-4, 1e-6) if dtype == torch.float32 else SGNS_TOL[dtype]
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, rtol, atol)
    if dtype == torch.bfloat16:
        _close(got[3], want[3], rtol, atol)
        return
    v, n, m = x[0].double(), x[2].double(), mask.double()[:, None]
    g_neg = torch.sigmoid(v @ n.T) * m                          # (B, S)
    exact, mag = g_neg.T @ v, g_neg.abs().T @ v.abs()           # (S, d)
    depth = (sgns.GRADS_ROWS + -(-plan.tiles // plan.blocks) + plan.blocks
             + d)
    err = (got[3].double() - exact).abs()
    assert (err <= depth * 2.0 ** -24 * mag + 1e-6).all(), err.max()


def _scatter_case(card, case, N=40, B=30, seed=0):
    rng = np.random.default_rng(seed)
    if case == "nodup":
        idx = rng.permutation(N)[:B]
    elif case == "same":
        idx = np.full(B, 3)
    else:                      # runs within 8-row blocks and across them
        idx = rng.integers(0, N, B)
        idx[::7] = 5
        idx[1:24:8] = idx[2:25:8] = idx[3:26:8] = 11
    return torch.from_numpy(idx.astype(np.int32)).to(card)


@pytest.mark.parametrize("dtype,upd_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=["f32", "bf16-f32upd", "bf16"])
@pytest.mark.parametrize("case,d", [("nodup", 64), ("same", 64), ("dup", 64),
                                    ("dup", 128), ("dup", 20)])
def test_scatter_kernels_match_plain_bitwise(card, dtype, upd_dtype, case, d):
    """The sorted scatter, the row-wise one and the plain version agree bit
    for bit: one defined order, one rounding per position."""
    rng = np.random.default_rng(d)
    idx = _scatter_case(card, case)
    table = torch.from_numpy(rng.normal(0, 1, (40, d)).astype(np.float32)
                             ).to(card, dtype)
    upd = torch.from_numpy(rng.normal(0, 3e-3, (30, d)).astype(np.float32)
                           ).to(card, upd_dtype)
    before = dict(sgns.LAUNCHES)
    got = sgns.scatter_add_rows(table.clone(), idx, upd)
    ref = sgns.scatter_add_rows_rowwise(table.clone(), idx, upd)
    want = sgns.scatter_add_rows_plain(table.clone(), idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ref, want)
    assert not torch.equal(got, table)
    for name in ("scatter_add_rows", "scatter_add_rows_rowwise"):
        assert sgns.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("dtype,upd_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=["f32", "bf16-f32upd", "bf16"])
def test_scatter_kernel_over_several_chunks(card, dtype, upd_dtype):
    """#9 with B = 3 P + 7 positions (four launches in one call) and a
    100-position run of one hub row across the chunk edges, bitwise against
    plain and the row-wise kernel (#10)."""
    d = 128
    P = sgns.plan_scatter(1, d, torch.empty(0, dtype=dtype).element_size(),
                          torch.empty(0, dtype=upd_dtype).element_size()
                          ).positions
    B = 3 * P + 7
    rng = np.random.default_rng(41)
    idx = rng.integers(0, 500, B)
    idx[rng.choice(B, 100, replace=False)] = 7      # the hub row's run
    idx = torch.from_numpy(idx.astype(np.int32)).to(card)
    table = torch.from_numpy(rng.normal(0, 1, (500, d)).astype(np.float32)
                             ).to(card, dtype)
    upd = torch.from_numpy(rng.normal(0, 3e-3, (B, d)).astype(np.float32)
                           ).to(card, upd_dtype)
    before = dict(sgns.LAUNCHES)
    got = sgns.scatter_add_rows(table.clone(), idx, upd)
    ref = sgns.scatter_add_rows_rowwise(table.clone(), idx, upd)
    want = sgns.scatter_add_rows_plain(table.clone(), idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ref, want)
    assert not torch.equal(got[7], table[7])
    for name in ("scatter_add_rows", "scatter_add_rows_rowwise"):
        assert sgns.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("dtype,upd_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=["f32", "bf16-f32upd", "bf16"])
def test_scatter_rowwise_kernel_over_its_own_chunks(card, dtype, upd_dtype):
    """#10 with B = 3 P + 7 positions for its own planned chunk P (four of
    its launches in one call) and a 100-position hub run across those chunk
    edges, bitwise against plain and the sorted kernel (#9)."""
    d = 128
    sizes = (torch.empty(0, dtype=dtype).element_size(),
             torch.empty(0, dtype=upd_dtype).element_size())
    P = sgns.plan_scatter_rowwise(*sizes)
    B = 3 * P + 7
    rng = np.random.default_rng(43)
    idx = rng.integers(0, 700, B)
    idx[rng.choice(B, 100, replace=False)] = 9      # the hub row's run
    idx = torch.from_numpy(idx.astype(np.int32)).to(card)
    table = torch.from_numpy(rng.normal(0, 1, (700, d)).astype(np.float32)
                             ).to(card, dtype)
    upd = torch.from_numpy(rng.normal(0, 3e-3, (B, d)).astype(np.float32)
                           ).to(card, upd_dtype)
    before = dict(sgns.LAUNCHES)
    ref = sgns.scatter_add_rows_rowwise(table.clone(), idx, upd)
    got = sgns.scatter_add_rows(table.clone(), idx, upd)
    want = sgns.scatter_add_rows_plain(table.clone(), idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(ref, want) and torch.equal(got, want)
    assert not torch.equal(ref[9], table[9])
    for name in ("scatter_add_rows", "scatter_add_rows_rowwise"):
        assert sgns.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gather_rowwise_matches_blocked_bitwise(card, dtype):
    tbl = torch.randn((1000, 128), device=card).to(dtype)
    before = sgns.LAUNCHES["gather_rows_rowwise"]
    for t in (tbl, tbl[:, :20].contiguous()):
        idx = torch.randint(0, 1000, (333,), device=card, dtype=torch.int32)
        got = sgns.gather_rows_rowwise(t, idx)
        assert torch.equal(got, sgns.gather_rows(t, idx))
        assert torch.equal(got, sgns.gather_rows_plain(t, idx))
    assert sgns.LAUNCHES["gather_rows_rowwise"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("impl", ["pallas", "pallas_fused"])
def test_step_routes_match_plain_composition(card, impl, dtype):
    """Each kernel route of ``ops.sgns_step`` against the ``ref`` route, the
    same composition through the plain functions, on the same card tensors;
    each route launches its kernels and no others."""
    x = _sgns_inputs(card, dtype, B=37, S=5, d=128, case="dup")
    before = dict(sgns.LAUNCHES)
    got = ops.sgns_step(x[0].clone(), x[1].clone(), *x[2:], 0.05, impl=impl)
    torch.cuda.synchronize()
    ran = {k: sgns.LAUNCHES[k] - before[k] for k in before}
    if impl == "pallas":
        assert ran["gather_rows"] == 3 and ran["sgns_grads"] == 1
    else:
        assert ran["sgns_fused_grads"] == 1
    assert ran["scatter_add_rows"] == 2 and ran["sgns_fused_update"] == 0
    want = ops.sgns_step(x[0].clone(), x[1].clone(), *x[2:], 0.05, impl="ref")
    torch.cuda.synchronize()
    assert sgns.LAUNCHES == {k: before[k] + ran[k] for k in before}
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    rtol, atol = SGNS_TOL[dtype]
    for g, w, b in zip(got[:2], want[:2], x[:2]):
        _close(g, w, rtol, atol)
        if dtype == torch.bfloat16:
            _within_bf16_steps(g, w, b)


def test_unfused_wrappers_raise_on_what_the_kernels_do_not_take(card):
    vert, ctx, iv, ic, inn, mask = _sgns_inputs(card, torch.float32)
    v, c, n = vert[iv.long()], ctx[ic.long()], ctx[inn.long()]
    with pytest.raises(ValueError, match="dtype"):
        sgns.sgns_grads(v.half(), c.half(), n.half(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        sgns.sgns_grads(v.t().contiguous().t(), c, n, mask)
    with pytest.raises(ValueError, match="mask"):
        sgns.sgns_grads(v, c, n, mask.double())
    upd = torch.zeros((iv.shape[0], 64), device=card)
    for fn in (sgns.scatter_add_rows, sgns.scatter_add_rows_rowwise):
        with pytest.raises(ValueError, match="idx"):
            fn(vert, iv.cpu(), upd)
        with pytest.raises(ValueError, match="idx"):
            fn(vert, iv.long(), upd)
        with pytest.raises(ValueError, match="upd"):
            fn(vert, iv, upd.t().contiguous().t())
        with pytest.raises(ValueError, match="upd"):
            fn(vert, iv, upd.bfloat16())
        with pytest.raises(ValueError, match="dtype"):
            fn(vert.half(), iv, upd)
        with pytest.raises(ValueError, match="overlaps"):
            fn(vert, iv, vert[: iv.shape[0]])
    with pytest.raises(ValueError, match="idx"):
        sgns.gather_rows_rowwise(vert, iv.cpu())


# flash attention (#11): f32 within tests/test_flash_attention.py's rtol
# 2e-4 / atol 2e-5, bf16 within its 2e-2 (other summation orders)
FLASH_CASES = [  # B, H, Hkv, Sq, Skv, hd, causal, window
    (2, 4, 4, 64, 64, 32, True, 0), (1, 4, 2, 64, 128, 32, True, 0),
    (2, 2, 2, 96, 96, 16, True, 24), (1, 2, 1, 64, 64, 64, False, 0),
    (1, 8, 8, 128, 128, 8, True, 0),
    (1, 2, 1, 100, 40, 64, True, 8),     # rows with no valid key, ragged
    (1, 4, 2, 33, 97, 128, True, 0),     # GQA, Sq < Skv, ragged, hd 128
    (2, 8, 2, 300, 300, 64, True, 50),   # granite's grouping, window
    # hd 128 and hd 8 with Sq, Skv not multiples of the 64-row/64-key tiles
    (2, 4, 2, 201, 77, 128, False, 0), (1, 4, 1, 150, 230, 128, True, 0),
    (1, 2, 2, 190, 190, 128, True, 70), (2, 4, 2, 131, 259, 8, False, 0),
    (1, 8, 4, 257, 257, 8, True, 0), (1, 2, 1, 100, 40, 8, True, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(card, dtype):
    from repro_torch.kernels import flash_attention as fa

    before = fa.LAUNCHES["flash_attention"]
    for i, (B, H, Hkv, Sq, Skv, hd, causal, window) in enumerate(FLASH_CASES):
        g = torch.Generator().manual_seed(70 + i)
        q, k, v = (0.5 * torch.randn(shape, generator=g)
                   for shape in ((B, Sq, H, hd), (B, Skv, Hkv, hd),
                                 (B, Skv, Hkv, hd)))
        # (B, S, H, hd) buffers as (B, H, S, hd) views, as attention passes
        q, k, v = (t.to(card, dtype).transpose(1, 2) for t in (q, k, v))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.mha_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert got.stride() == q.stride()
        tol = (dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32
               else dict(rtol=2e-2, atol=2e-2))
        torch.testing.assert_close(got.float(), want.float(), **tol)
    assert fa.LAUNCHES["flash_attention"] == before + len(FLASH_CASES)


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros((1, 4, 8, 64), device=card)
    k = torch.zeros((1, 2, 8, 64), device=card)
    for bad in (dict(q=q[..., :48].contiguous(), k=k[..., :48].contiguous()),
                dict(k=k.bfloat16()), dict(k=k.cpu()),
                dict(q=q.transpose(2, 3).contiguous().transpose(2, 3))):
        args = {"q": q, "k": k, **bad}
        with pytest.raises(ValueError):
            fa.flash_attention(args["q"], args["k"], args["k"])


def test_flash_wrapper_raises_on_unaligned_views(card):
    """The kernel copies 16 bytes at a time: a view whose pointer or row
    stride is not a multiple of 16 bytes raises before any launch."""
    from repro_torch.kernels import flash_attention as fa

    k = torch.zeros((1, 2, 8, 64), device=card)
    before = fa.LAUNCHES["flash_attention"]
    for q in (torch.zeros((1, 4, 8, 68), device=card)[..., 1:65],  # pointer
              torch.zeros((1, 4, 8, 65), device=card)[..., :64]):  # rows
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention(q, k, k)
    kb = torch.zeros((1, 2, 8, 68), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(kb[..., :64].new_zeros((1, 4, 8, 64)), kb[..., :64],
                           kb[..., :64])                       # 136-byte rows
    assert fa.LAUNCHES["flash_attention"] == before


def test_lm_prefill_routes_agree_on_card(card):
    """Reduced granite on the card: prefill on the flash kernel equals the
    masked plain route within 2e-3 (the LM tests' tolerance), one kernel
    launch per layer."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm

    cfg = configs.get_config("granite-3-2b").reduced()
    params = tfm.init_params(cfg, seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens.to(card)}
    before = (fa.LAUNCHES["flash_attention"], dict(attn.ROUTE_CALLS))
    lf, _ = tfm.prefill(params, batch, cfg, 128)
    lm, _ = tfm.prefill(params, batch, cfg, 128, flash=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before[0] + cfg.num_layers
    assert attn.ROUTE_CALLS["masked_calls"] == (before[1]["masked_calls"]
                                                + cfg.num_layers)
    torch.testing.assert_close(lf, lm, rtol=2e-3, atol=2e-3)
