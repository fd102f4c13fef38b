"""Embedding training launcher, on the card by default.

The port of the embedding mode of the JAX package's ``launch/train.py``:
the decoupled walk engine (async, one epoch ahead), the episode pipeline,
the single-card hybrid trainer with the CUDA SGNS kernels (``--impl`` picks
the route, the fused update by default), periodic resume checkpoints and
the link-prediction AUC.

    PYTHONPATH=src python -m repro_torch.launch.train --graph-kind sbm \\
        --nodes 1200 --epochs 12 --episodes 3 --dim 128 --subparts 2 \\
        --minibatch 32 --negatives 8 --neg-pool 2048 --min-auc 0.62

``--device cuda`` (the default) trains through the CUDA kernel and fails if
there is no card; ``--device cpu`` trains through its plain version. It
prints one ``epoch N loss … AUC …`` line per epoch, writes
``embeddings_<epochs>.npz`` (and ``resume.npz`` with ``--ckpt-every``) in the
JAX package's checkpoint format, so either package loads the other's files,
and ends with a summary line: edges trained per second and the mean
episode seconds.

Several ranks: under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment) each process is one
rank of the mesh ``(1, WORLD_SIZE)``, as the JAX launcher builds ``(1,
n_dev)``; without them the launcher runs one rank. Every rank builds the
same graph, walks and blocks from ``--seed`` and stages only its own row;
the vertex shards rotate between the ranks (``core.ring``). Rank 0 gathers
both tables, prints, evaluates and writes the checkpoint and resume files
(the same format). ``--device cuda`` gives each rank ``cuda:LOCAL_RANK``
(``nccl``); an explicit ``--device cuda:N`` places every rank on that one
card (``gloo``, host-staged); ``--device cpu`` runs ``gloo`` on the CPU:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --graph-kind \
        sbm --nodes 1200 --epochs 12 --episodes 3 --subparts 2 ...

Fault tolerance: ``--ckpt-every N`` writes an atomic, checksummed resume
checkpoint (tables + mid-epoch cursor) every N episodes; ``--resume``
continues from it. ``--stall-timeout-s`` bounds how long any stage may block
without store progress before failing with diagnostics instead of hanging.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def _ranks(args):
    """(world size, rank, this rank's device, backend or None) from the
    ``torchrun`` environment; one rank without it."""
    import torch

    from repro_torch.core.ring import backend_for
    from repro_torch.device import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1, 0, resolve_device(args.device), None
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    name = str(args.device)
    # "cuda" alone: a card a rank; an explicit index: every rank on it
    shared = name != "cuda"
    device = resolve_device(f"cuda:{local}" if name == "cuda" else name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return world, rank, device, backend_for(device, shared)


def train_embedding(args) -> dict:
    import torch.distributed as dist

    # fail before any graph work
    world, rank, device, backend = _ranks(args)
    if backend is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                                 f"{os.environ['MASTER_PORT']}",
            world_size=world, rank=rank)
    try:
        return _train_ranks(args, world, rank, device)
    finally:
        if backend is not None:
            dist.destroy_process_group()


def _train_ranks(args, world, rank, device) -> dict:
    from repro_torch.configs.tencent_embedding import SMALL
    from repro_torch.core import (EpisodePipeline, HybridConfig,
                                  HybridEmbeddingTrainer)
    from repro_torch.core import eval as ev
    from repro_torch.graph.csr import build_csr
    from repro_torch.graph.generators import powerlaw_graph, sbm_graph
    from repro_torch.train.checkpoint import load_arrays
    from repro_torch.walk import MemorySampleStore, WalkConfig, WalkEngine

    say = print if rank == 0 else (lambda *a, **kw: None)
    if args.graph:
        from repro_torch.graph.io import load_edge_list
        g_full = load_edge_list(args.graph)
    elif args.graph_kind == "sbm":
        # candidate-pair budget must scale with n or large graphs come out
        # mostly degree-0 (expected edges ~ rounds * batch * 0.0075)
        g_full = sbm_graph(args.nodes, rounds=max(30, args.nodes // 40),
                           seed=args.seed)
    else:
        g_full = powerlaw_graph(args.nodes, 5, seed=args.seed)
    train_e, test_e = ev.split_edges(g_full, 0.03, seed=args.seed)
    g = build_csr(train_e, g_full.num_nodes, symmetrize=False, dedup=False)
    neg_e = ev.sample_negative_pairs(g_full, len(test_e), seed=args.seed + 1)
    say(f"graph: {g.num_nodes} nodes / {g.num_edges} train edges; "
        f"{len(test_e)} held out" + (f"; {world} ranks" if world > 1 else ""))

    cfg_kw = {}
    if args.dtype is not None:          # None -> HybridConfig default (bf16)
        cfg_kw["dtype"] = args.dtype
    cfg = HybridConfig(dim=args.dim,
                       minibatch=args.minibatch or SMALL.minibatch,
                       negatives=args.negatives or SMALL.negatives,
                       subparts=args.subparts,
                       neg_pool=args.neg_pool or SMALL.neg_pool,
                       lr=args.lr, seed=args.seed, impl=args.impl,
                       **cfg_kw)
    trainer = HybridEmbeddingTrainer(g.num_nodes, cfg, degrees=g.degrees(),
                                     dims=(1, world), device=device)

    # crash-resume: restore tables + (epoch, episode) cursor from the last
    # resume checkpoint; the remaining episodes replay as an uninterrupted
    # run would (per-episode RNG streams are keyed by the config)
    start_epoch, start_episode = 0, 0
    resume_path = os.path.join(args.out_dir, "resume.npz")
    if args.resume:
        data, _ = load_arrays(resume_path)   # verifies the crc manifest
        start_epoch, start_episode = (int(v) for v in data["__cursor__"])
        trainer.set_embeddings(data["vertex"], data["context"])
        say(f"resume <- {resume_path} @ epoch {start_epoch} "
            f"episode {start_episode}")
        if start_epoch >= args.epochs:
            say("resume cursor is past the final epoch; nothing to do")
            return {"auc": None, "edges": 0, "episodes": 0}
    else:
        trainer.init_embeddings()

    # bounded store: the walker can run at most store_depth episodes ahead of
    # the pipeline's drops, so peak sample memory is O(depth · episode)
    store_depth = args.store_depth or args.pipeline_depth + 1
    store_kw = {}
    if args.stall_timeout_s is not None:
        store_kw["stall_timeout_s"] = (args.stall_timeout_s
                                       if args.stall_timeout_s > 0 else None)
    store = MemorySampleStore(depth=store_depth, **store_kw)
    wcfg = WalkConfig(walk_length=10, window=5, episodes=args.episodes,
                      seed=args.seed, workers=args.walk_workers)
    pipe = EpisodePipeline(store, trainer.part, pad_multiple=cfg.minibatch,
                           block_cap=args.block_cap,
                           depth=args.pipeline_depth,
                           stage_fn=trainer.stage_blocks,
                           device=trainer.device,
                           drop_consumed=True)
    os.makedirs(args.out_dir, exist_ok=True)

    def mk_walker():
        return WalkEngine(g, wcfg, store)

    engine = mk_walker()
    engine.start_async(start_epoch)
    try:
        return _train_embedding_epochs(args, cfg, trainer, engine, store,
                                       pipe, test_e, neg_e,
                                       mk_walker=mk_walker,
                                       start_epoch=start_epoch,
                                       start_episode=start_episode, say=say)
    finally:
        # always drain the prefetch workers: an in-flight build racing
        # interpreter teardown can crash inside numpy after module unload
        pipe.close()


def _write_resume(args, trainer, epoch, next_ep):
    """Atomic resume checkpoint: tables + checksummed (epoch, episode)
    cursor. ``next_ep`` is the NEXT episode to train; a full epoch
    normalizes to (epoch+1, 0) so resume never re-enters a finished epoch.
    Every rank gathers the tables; rank 0 writes them."""
    from repro_torch.train.checkpoint import save_checkpoint

    cur = (epoch + 1, 0) if next_ep >= args.episodes else (epoch, next_ep)
    path = os.path.join(args.out_dir, "resume.npz")
    tables = {"vertex": trainer.embeddings(),
              "context": trainer.context_embeddings()}
    if trainer.rank == 0:
        save_checkpoint(path, tables, step=epoch * args.episodes + next_ep,
                        extra={"__cursor__": np.asarray(cur, np.int64)})
    return path


def _train_embedding_epochs(args, cfg, trainer, engine, store, pipe,
                            test_e, neg_e, *, mk_walker,
                            start_epoch=0, start_episode=0,
                            say=print) -> dict:
    from repro_torch.core import eval as ev
    from repro_torch.obs import counter_add, observe, span
    from repro_torch.train.checkpoint import save_checkpoint

    auc = 0.0
    loss_s = "--"
    path = None
    edges, train_s, n_episodes = 0, 0.0, 0
    ckpt_every = max(0, args.ckpt_every)
    for epoch in range(start_epoch, args.epochs):
        # streamed: do NOT join — training starts as soon as episode 0 lands
        # in the bounded store; the walker streams the rest concurrently
        t0 = time.perf_counter()
        nxt = None
        losses = []
        # resuming mid-epoch: episodes before the cursor were already trained
        # into the restored tables — drain them from the walker's stream
        # without training so the bounded store keeps flowing
        skip_until = start_episode if epoch == start_epoch else 0
        try:
            for ep in range(args.episodes):
                if ep < skip_until:
                    store.get(epoch, ep)
                    store.drop(epoch, ep)
                    continue
                pipe.prefetch_window(epoch, ep, args.episodes)
                eb = pipe.get(epoch, ep)
                t_ep = time.perf_counter()
                with span("train_episode", "train",
                          {"epoch": epoch, "episode": ep}):
                    # the loss comes back as a float: the episode's device
                    # work is done when train_episode returns
                    losses.append(trainer.train_episode(
                        eb, lr=cfg.lr * max(1 - epoch / args.epochs, 0.05)))
                dt = time.perf_counter() - t_ep
                observe("train.episode_s", dt)
                counter_add("train.episodes")
                edges += eb.num_samples
                train_s += dt
                n_episodes += 1
                # paper: walks for e+1 overlap training e — launch them the
                # moment this epoch's walker finishes (backpressure-paced)
                if nxt is None and epoch + 1 < args.epochs and engine.finished():
                    engine.join()        # surfaces walker errors
                    nxt = mk_walker()
                    nxt.start_async(epoch + 1)
                if ckpt_every and (epoch * args.episodes + ep + 1) % ckpt_every == 0:
                    rpath = _write_resume(args, trainer, epoch, ep + 1)
                    say(f"  resume checkpoint -> {rpath} "
                        f"@ ({epoch}, {ep + 1})")
        except Exception:
            # a dead walker finishes the epoch with episodes missing, which
            # surfaces here as a KeyError — join to re-raise its real error.
            # abandon() first: with nobody left to drain the bounded store, a
            # HEALTHY walker could be blocked in put() and join would hang
            store.abandon()
            engine.join()
            raise
        engine.join()
        if nxt is None and epoch + 1 < args.epochs:
            nxt = mk_walker()
            nxt.start_async(epoch + 1)
        store.drop_epoch(epoch)
        with span("eval", "train", {"epoch": epoch}):
            V = trainer.embeddings()
            Vf = V.float().numpy()
            Vn = Vf / (np.linalg.norm(Vf, axis=1, keepdims=True) + 1e-9)
            auc = ev.auc_score(
                np.einsum("ij,ij->i", Vn[test_e[:, 0]], Vn[test_e[:, 1]]),
                np.einsum("ij,ij->i", Vn[neg_e[:, 0]], Vn[neg_e[:, 1]]))
        loss_s = f"{np.mean(losses):.4f}" if losses else "--"
        say(f"epoch {epoch:3d} loss {loss_s} AUC {auc:.4f} "
            f"({time.perf_counter()-t0:.1f}s)")
        if epoch + 1 < args.epochs:
            engine = nxt
        if epoch + 1 == args.epochs:
            path = os.path.join(args.out_dir, f"embeddings_{epoch+1}.npz")
            C = trainer.context_embeddings()
            if trainer.rank == 0:
                save_checkpoint(path, {"vertex": V, "context": C},
                                step=epoch + 1)
            say(f"  checkpoint -> {path}")
    rate = edges / train_s if train_s > 0 else 0.0
    mean_ep = train_s / n_episodes if n_episodes else 0.0
    ranks = trainer.part.num_shards
    say(f"trained {edges} edges in {n_episodes} episodes on "
        f"{trainer.device}" + (f" x {ranks} ranks" if ranks > 1 else "")
        + f" (impl {cfg.impl}): {rate:.1f} edges/s, mean episode "
        f"{mean_ep:.4f}s")
    if args.min_auc is not None and auc < args.min_auc:
        raise SystemExit(
            f"final AUC {auc:.4f} below --min-auc {args.min_auc}")
    return {"auc": float(auc), "loss": loss_s, "edges": edges,
            "train_s": train_s, "edges_per_s": rate, "episode_s": mean_ep,
            "episodes": n_episodes, "checkpoint": path, "ranks": ranks}


def main(argv=None) -> dict:
    """Run the trainer; returns ``{"auc", "loss", "edges", "train_s",
    "edges_per_s", "episode_s", "episodes", "checkpoint"}``."""
    from repro_torch.kernels.ops import STEP_IMPLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--lr", type=float, default=0.025)
    ap.add_argument("--graph", default=None, help="edge-list file (.npy/.txt)")
    ap.add_argument("--graph-kind", default="powerlaw",
                    choices=["powerlaw", "sbm"],
                    help="synthetic graph when no --graph file: powerlaw "
                         "(paper's social-network topology) or sbm (planted "
                         "communities — use when gating on --min-auc)")
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--episodes", type=int, default=4)
    ap.add_argument("--subparts", type=int, default=4)
    ap.add_argument("--minibatch", type=int, default=None,
                    help="shared-negative group rows (default: SMALL config)")
    ap.add_argument("--negatives", type=int, default=None,
                    help="shared negatives per minibatch (default: SMALL)")
    ap.add_argument("--neg-pool", type=int, default=None,
                    help="per-device negative pool size (default: SMALL)")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="embedding-table dtype (default: the HybridConfig "
                         "default, bfloat16; pass float32 for the "
                         "paper-faithful tables)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="episodes between atomic resume checkpoints "
                         "(OUT_DIR/resume.npz: tables + cursor, crc-"
                         "manifested; 0 = final artifact only)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from OUT_DIR/resume.npz — restores tables "
                         "+ (epoch, episode) cursor and trains the rest of "
                         "the run")
    ap.add_argument("--stall-timeout-s", type=float, default=None,
                    help="seconds without sample-store progress before a "
                         "blocked stage fails with StoreStalled diagnostics "
                         "(default 600; <=0 disables the deadline — producer "
                         "liveness detection still applies)")
    ap.add_argument("--walk-workers", type=int, default=2,
                    help="walk-engine chunk worker threads (1 = inline; the "
                         "sample stream is identical for any value)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="episodes in flight through the fetch/build/stage "
                         "pipeline")
    ap.add_argument("--store-depth", type=int, default=None,
                    help="bounded-store capacity in undrained episodes "
                         "(default: pipeline depth + 1)")
    ap.add_argument("--block-cap", type=int, default=None,
                    help="pin every episode's per-cell block capacity (rounds "
                         "up to the minibatch pad); samples past it are "
                         "dropped (default: per-episode max cell count)")
    ap.add_argument("--min-auc", type=float, default=None,
                    help="exit non-zero if the final epoch's link-prediction "
                         "AUC is below this (CI sanity gate)")
    ap.add_argument("--impl", default="pallas_fused2", choices=STEP_IMPLS,
                    help="SGNS minibatch route (kernels.ops.sgns_step): "
                         "pallas_fused2 (default) launches the fused CUDA "
                         "update (gather, gradients, duplicate combine, SGD) "
                         "once per minibatch; pallas_fused the fused "
                         "gather-and-gradients kernel, then two row "
                         "scatter-add kernels; pallas three row gathers, the "
                         "gradients kernel and two scatter-adds; ref the "
                         "plain PyTorch composition, no CUDA kernel. The JAX "
                         "launcher's default is ref")
    ap.add_argument("--device", default="cuda",
                    help="training device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    return train_embedding(args)


if __name__ == "__main__":
    main()
