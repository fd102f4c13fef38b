"""The multi-rank rings of the port's trainer against the JAX episode step.

Four ``gloo`` ranks on the CPU, one process each, run one episode on a 2x2
mesh with k = 2 sub-parts and must match the JAX package's
``build_episode_fn`` on a 4-device host mesh (a subprocess with
``--xla_force_host_platform_device_count=4``, as ``tests/test_distributed.py``
runs it), which also gives the tables' init, the pools and each device's
negative stream. The ranks also draw that stream themselves, bit for bit,
and train two episodes on it. Then the port's own claims: the bulk shift
(``fuse_subpart_permute=False``) trains the same tables bit for bit, each
rank's vertex shard is home after the episode, the 2x2 mesh reaches the
quality of one rank (the port's form of
``test_hybrid_multidevice_quality_parity``), and two ranks started through
the launcher's ``torchrun`` environment write a checkpoint the JAX serving
store loads.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
CFG = dict(dim=32, minibatch=32, negatives=8, subparts=2, neg_pool=2048,
           lr=0.05, seed=3)
NODES, PAIRS, SEED, LR = 301, 1200, 7, 0.04
# tests/test_torch_train.py's tolerances for one episode (rtol, atol)
TOL = {"float32": (2e-4, 1e-6), "bfloat16": (3e-2, 3e-3)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    # one thread a process: the ranks share the machine's cores
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               **{k: str(v) for k, v in extra.items()})
    env.pop("XLA_FLAGS", None)
    return env


def _run_ranks(code, world, *args, timeout=240, env=None):
    """``python -c code *args`` once per rank, with the ``torchrun``
    variables set; every rank must exit 0. Returns their outputs."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *map(str, args)],
        env=_env(WORLD_SIZE=world, RANK=r, LOCAL_RANK=r,
                 MASTER_ADDR="localhost", MASTER_PORT=port, **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    return outs


JAX_EPISODE = r"""
import json, sys
import jax, numpy as np
from repro.core import HybridConfig, HybridEmbeddingTrainer
from repro.core.partition import build_episode_blocks
cfg, nodes, n_pairs, seed, lr, out = json.loads(sys.argv[1])
rng = np.random.default_rng(seed)
degrees = rng.integers(1, 20, nodes)
pairs = rng.integers(0, nodes, size=(n_pairs, 2)).astype(np.int32)
mesh = jax.make_mesh((2, 2), ("data", "model"))
res = {}
for dtype in ("float32", "bfloat16"):
    jt = HybridEmbeddingTrainer(nodes, mesh,
                                HybridConfig(**cfg, dtype=dtype, impl="ref"),
                                degrees=degrees)
    jt.init_embeddings()
    words = lambda a: np.asarray(a).view(np.uint16 if dtype == "bfloat16"
                                         else np.float32)
    v0, c0 = words(jt.embeddings()), words(jt.context_embeddings())
    eb = build_episode_blocks(pairs, jt.part, pad_multiple=cfg["minibatch"])
    k, S, mb = cfg["subparts"], cfg["negatives"], cfg["minibatch"]
    nmb, R = eb.block_cap // mb, 4
    # each device's pool positions: fold_in(PRNGKey(seed), p), one split
    # per minibatch in (round, sub-part, minibatch) order, padding included
    draws = np.zeros((4, R, k, nmb, S), np.int64)
    for p in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), p)
        for r in range(R):
            for j in range(k):
                for i in range(nmb):
                    key, kneg = jax.random.split(key)
                    draws[p, r, j, i] = np.asarray(jax.random.randint(
                        kneg, (S,), 0, cfg["neg_pool"]))
    loss = jt.train_episode(eb, lr=lr)
    res.update({f"{dtype}_v0": v0, f"{dtype}_c0": c0,
                f"{dtype}_v1": np.asarray(jt.embeddings()).astype(np.float32),
                f"{dtype}_c1": np.asarray(
                    jt.context_embeddings()).astype(np.float32),
                f"{dtype}_loss": np.float64(loss), f"{dtype}_draws": draws,
                "pool": jt.pool, "degrees": degrees, "pairs": pairs})
    # a second episode on the same blocks (the stream restarts)
    loss = jt.train_episode(eb, lr=lr)
    res.update({f"{dtype}_v2": np.asarray(jt.embeddings()).astype(np.float32),
                f"{dtype}_c2": np.asarray(
                    jt.context_embeddings()).astype(np.float32),
                f"{dtype}_loss2": np.float64(loss)})
np.savez(out, **res)
"""

PORT_EPISODE = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import HybridConfig, HybridEmbeddingTrainer
from repro_torch.core.partition import build_episode_blocks
from repro_torch.kernels import ops
cfg, nodes, lr, ref, out = json.loads(sys.argv[1])
# each minibatch's own loss and block (its running sum's offset), and the
# rank's loss sum as it enters the f64 all-sum
seen, local = [], []
real_step = ops.sgns_step
def spy(*args, loss_into, **kw):
    v, c, loss = real_step(*args, **kw)
    seen.append((loss_into.storage_offset(), np.float32(loss.item())))
    return v, c, loss_into.add_(loss)
ops.sgns_step = spy
def scan_sum():
    # JAX's scan carry: lacc + loss inside a block from 0, lacc + lj a block
    blocks = {}
    for blk, loss in seen:
        blocks[blk] = np.float32(blocks.get(blk, np.float32(0)) + loss)
    lacc = np.float32(0)
    for blk in sorted(blocks):
        lacc = np.float32(lacc + blocks[blk])
    return lacc
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="tcp://localhost:"
                        + os.environ["MASTER_PORT"], world_size=world,
                        rank=rank)
ref = np.load(ref)
res = {}
for dtype in ("float32", "bfloat16"):
    def table(a):
        if dtype == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    tables = {}
    for fused in (True, False):
        tt = HybridEmbeddingTrainer(
            nodes, HybridConfig(**cfg, dtype=dtype,
                                fuse_subpart_permute=fused),
            degrees=ref["degrees"], dims=(2, 2), device="cpu")
        assert np.array_equal(tt.pool, ref["pool"])
        tt.set_embeddings(table(ref[f"{dtype}_v0"]), table(ref[f"{dtype}_c0"]))
        eb = build_episode_blocks(ref["pairs"], tt.part,
                                  pad_multiple=cfg["minibatch"])
        seen.clear(), local.clear()
        all_sum = tt.ring.all_sum
        tt.ring.all_sum = lambda x: local.append(x.clone()) or all_sum(x)
        loss = tt.train_episode(eb, lr=lr,
                                neg_draws=ref[f"{dtype}_draws"][rank])
        # 4 rounds x k sub-parts, each block's sum then the episode's, in
        # JAX's order and bit for bit
        assert len({blk for blk, _ in seen}) == 4 * cfg["subparts"], seen
        assert local[0][0].item() == float(scan_sum()), (local, seen)
        rows = tt.part.padded_rows_per_shard
        # the shard this rank holds after the episode is its own: its rows
        # of the gathered table
        V, C = tt.embeddings(), tt.context_embeddings()
        mine = tt.vert[: max(0, min(rows, nodes - rank * rows))]
        assert torch.equal(mine, V[rank * rows: rank * rows + mine.shape[0]])
        tables[fused] = (V, C, loss)
    # nothing injected: the trainer draws each device's JAX stream itself
    # (bit for bit), then trains two episodes on it
    tt = HybridEmbeddingTrainer(nodes, HybridConfig(**cfg, dtype=dtype),
                                degrees=ref["degrees"], dims=(2, 2),
                                device="cpu")
    tt.set_embeddings(table(ref[f"{dtype}_v0"]), table(ref[f"{dtype}_c0"]))
    eb = build_episode_blocks(ref["pairs"], tt.part,
                              pad_multiple=cfg["minibatch"])
    pos = tt._negative_positions(4, cfg["subparts"],
                                 eb.block_cap // cfg["minibatch"], None)
    own_draws = bool(np.array_equal(pos.numpy(), ref[f"{dtype}_draws"][rank]))
    for _ in range(2):
        own_loss = tt.train_episode(eb, lr=lr)
    V3, C3 = tt.embeddings(), tt.context_embeddings()
    draws_ok = torch.tensor([int(own_draws)])
    dist.all_reduce(draws_ok, op=dist.ReduceOp.MIN)
    if rank == 0:
        res.update({f"{dtype}_own_draws": bool(draws_ok.item()),
                    f"{dtype}_v2": V3.float().numpy(),
                    f"{dtype}_c2": C3.float().numpy(),
                    f"{dtype}_loss2": own_loss})
    if rank == 0:
        (V, C, loss), (V2, C2, loss2) = tables[True], tables[False]
        res.update({f"{dtype}_v1": V.float().numpy(),
                    f"{dtype}_c1": C.float().numpy(), f"{dtype}_loss": loss,
                    f"{dtype}_bulk_same": bool(torch.equal(V, V2)
                                               and torch.equal(C, C2)
                                               and loss == loss2)})
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """(JAX results, port results) of one episode at f32 and bf16."""
    d = tmp_path_factory.mktemp("ring")
    ref, out = str(d / "jax.npz"), str(d / "port.npz")
    r = subprocess.run(
        [sys.executable, "-c", JAX_EPISODE,
         json.dumps([CFG, NODES, PAIRS, SEED, LR, ref])],
        env=dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    _run_ranks(PORT_EPISODE, 4, json.dumps([CFG, NODES, LR, ref, out]))
    return np.load(ref), np.load(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_four_gloo_ranks_match_jax_episode(episodes, dtype):
    """Four ranks, 2x2 mesh, k = 2, the JAX stream of each device replayed:
    tables within the one-episode tolerances, loss within 1e-4; each rank's
    loss sum, 4 rounds x 2 sub-parts of blocks, was JAX's scan order of its
    minibatches' losses bit for bit (checked in the ranks)."""
    jax_res, port = episodes
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(port[f"{dtype}_loss"], jax_res[f"{dtype}_loss"],
                               rtol=1e-4)
    for name in ("v1", "c1"):
        np.testing.assert_allclose(port[f"{dtype}_{name}"],
                                   jax_res[f"{dtype}_{name}"], rtol=rtol,
                                   atol=atol)
    # the episode moved the tables: the rings did train something
    assert not np.allclose(jax_res[f"{dtype}_c1"], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bulk_shift_trains_the_same_bits(episodes, dtype):
    """fuse_subpart_permute=False (one bulk shift a round) gives the same
    tables and loss bit for bit; every rank's shard was home (checked in
    the ranks)."""
    assert bool(episodes[1][f"{dtype}_bulk_same"])


def test_four_ranks_draw_each_devices_jax_stream(episodes):
    """With no ``neg_draws`` every rank's positions are its device's JAX
    stream, ``fold_in(PRNGKey(seed), rank)`` split once a minibatch over 4
    rounds x 2 sub-parts, bit for bit (checked in the ranks)."""
    for dtype in ("float32", "bfloat16"):
        assert bool(episodes[1][f"{dtype}_own_draws"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_four_ranks_two_episodes_on_their_own_draws(episodes, dtype):
    """Two episodes with nothing injected meet the one-episode tolerances
    against the JAX step's two episodes."""
    jax_res, port = episodes
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(port[f"{dtype}_loss2"],
                               jax_res[f"{dtype}_loss2"], rtol=1e-4)
    for name in ("v2", "c2"):
        np.testing.assert_allclose(port[f"{dtype}_{name}"],
                                   jax_res[f"{dtype}_{name}"], rtol=rtol,
                                   atol=atol)


QUALITY = r"""
import json, os, sys
import numpy as np
import torch.distributed as dist
from repro_torch.core import HybridConfig, HybridEmbeddingTrainer
from repro_torch.core import eval as ev
from repro_torch.core.partition import build_episode_blocks
from repro_torch.graph.csr import build_csr
from repro_torch.walk import MemorySampleStore, WalkConfig, WalkEngine
dims, k, out = json.loads(sys.argv[1])
world = int(os.environ.get("WORLD_SIZE", "1"))
if world > 1:
    dist.init_process_group("gloo", init_method="tcp://localhost:"
                            + os.environ["MASTER_PORT"], world_size=world,
                            rank=int(os.environ["RANK"]))
rng = np.random.default_rng(0)
n = 1200
comm = rng.integers(0, 12, n)
src, dst = [], []
for _ in range(30):
    a = rng.integers(0, n, 20000); b = rng.integers(0, n, 20000)
    keep = rng.random(20000) < np.where(comm[a] == comm[b], 0.08, 0.001)
    src.append(a[keep]); dst.append(b[keep])
g_full = build_csr(np.stack([np.concatenate(src), np.concatenate(dst)], 1), n)
train_e, test_e = ev.split_edges(g_full, 0.05, seed=1)
g = build_csr(train_e, n, symmetrize=False, dedup=False)
neg_e = ev.sample_negative_pairs(g_full, len(test_e), seed=3)
cfg = HybridConfig(dim=64, minibatch=32, negatives=8, subparts=k,
                   neg_pool=2048, lr=0.025)
tr = HybridEmbeddingTrainer(n, cfg, degrees=g.degrees(), dims=tuple(dims),
                            device="cpu")
tr.init_embeddings()
store = MemorySampleStore()
E = 10
for epoch in range(E):
    WalkEngine(g, WalkConfig(walk_length=10, window=5, episodes=1,
                             seed=epoch), store).run_epoch(epoch)
    eb = build_episode_blocks(np.asarray(store.get(epoch, 0)), tr.part,
                              pad_multiple=32)
    assert eb.dropped == 0
    tr.train_episode(eb, lr=0.025 * max(1 - epoch / E, 0.05))
    store.drop_epoch(epoch)
V = tr.embeddings().float().numpy()
Vn = V / (np.linalg.norm(V, axis=1, keepdims=True) + 1e-9)
auc = ev.auc_score(np.einsum("ij,ij->i", Vn[test_e[:, 0]], Vn[test_e[:, 1]]),
                   np.einsum("ij,ij->i", Vn[neg_e[:, 0]], Vn[neg_e[:, 1]]))
if tr.rank == 0:
    with open(out, "w") as f:
        f.write(repr(float(auc)))
if world > 1:
    dist.destroy_process_group()
"""


def test_two_by_two_mesh_reaches_one_rank_quality(tmp_path):
    """The port's form of test_hybrid_multidevice_quality_parity: 2x2 with
    k = 2 sub-parts in four gloo ranks reaches at least one rank's AUC
    minus 0.04 on the same SBM graph and walks."""
    one, four = str(tmp_path / "one"), str(tmp_path / "four")
    _run_ranks(QUALITY, 1, json.dumps([[1, 1], 1, one]))
    _run_ranks(QUALITY, 4, json.dumps([[2, 2], 2, four]))
    a1, a4 = (float(open(p).read()) for p in (one, four))
    assert a1 > 0.62, a1
    assert a4 > a1 - 0.04, (a1, a4)


def test_launcher_two_ranks_checkpoint_loads_in_jax(tmp_path):
    """Two CPU ranks through the launcher under the torchrun environment:
    rank 0 writes the checkpoint (the JAX package's format), which the JAX
    serving store loads and serves at recall 1.0 against its oracle."""
    from repro.embed_serve.store import ShardedEmbeddingStore, recall_at_k

    out = str(tmp_path / "run")
    code = ("import sys; from repro_torch.launch import train; "
            "train.main(sys.argv[1:])")
    outs = _run_ranks(code, 2, "--nodes", "400", "--epochs", "2",
                      "--episodes", "2", "--dim", "32", "--walk-workers",
                      "1", "--subparts", "2", "--out-dir", out,
                      "--device", "cpu")
    assert "2 ranks" in outs[0] and "checkpoint ->" in outs[0]
    assert "epoch" not in outs[1] and "checkpoint" not in outs[1]
    store = ShardedEmbeddingStore.load(os.path.join(out, "embeddings_2.npz"))
    assert store.num_nodes == 400
    q = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32)
    _, got = store.topk(q, 10, impl="xla")
    _, want = store.oracle_topk(q, 10)
    assert recall_at_k(np.asarray(got), np.asarray(want)) == 1.0
