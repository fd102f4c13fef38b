"""Training launcher, on the card by default: the paper's embedding
trainer (``--arch tencent-embedding``, the default) and the LM trainer
(any other ``--arch``).

The port of the JAX package's ``launch/train.py``. The embedding mode: the
decoupled walk engine (async, one epoch ahead), the episode pipeline, the
single-card hybrid trainer with the CUDA SGNS kernels (``--impl`` picks
the route, the fused update by default), periodic resume checkpoints and
the link-prediction AUC.

The LM mode (``--arch qwen1.5-0.5b`` or any other LM arch: dense, MoE,
MLA with MTP, SSM, hybrid, VLM, enc-dec): random weights from ``--seed``,
``TokenPipeline``'s seeded Markov token stream (``data/tokens.py``; a
VLM's batches carry its patch embeddings, an enc-dec arch's its encoder
frames, as many as tokens), and ``--steps`` steps of
``train/train_step.py``
(the config's optimizer, its ``train_microbatches``, MoE layers through
the expert dispatch as JAX's trainer under its host mesh); it prints the
JAX launcher's lines (``{arch}: {n}M params``, ``step {s:5d} loss ...
grad_norm ...`` every ``--log-every`` steps and at the last) and with
``--save`` writes ``OUT_DIR/lm_final.npz`` in the JAX tree layout, which
JAX's ``restore_checkpoint`` reads. ``--reduced`` cuts the arch to
``--layers`` layers (4 unless given) of width ``--d-model`` (4 experts,
vocab ≤ 8,192, one microbatch); without it ``--layers`` keeps the arch's
widths and cuts its depth. Its attention is the masked plain path, as JAX's training
takes: the LM mode launches no kernel of the port. An arch whose f32
weights exceed the device (deepseek-v3-671b, jamba-v0.1-52b at full depth)
exits before it allocates.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the LM mode builds the ``(1,
WORLD_SIZE)`` ``("data", "model")`` mesh (``sharding/mesh.py``), as JAX's
``train_lm`` builds ``make_host_mesh()``: every rank makes the whole tree
from ``--seed`` and keeps its shards by ``param_shardings``, the optimizer
state is sharded by its own specs, and each step is the sharded train step
(tensor parallel over heads, FFN width and vocabulary, expert parallel
MoE, ``train/train_step.py``). Rank 0 prints the step lines, and
``--save`` writes the gathered tree in the same npz format. The devices
and backend follow the embedding mode's rule (below): ``--device cuda`` a
card a rank (``nccl``), ``cuda:N`` every rank on that card (``gloo``,
host-staged), ``cpu`` ``gloo``:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch \
        phi3.5-moe-42b-a6.6b --reduced --steps 3 --batch 4 --seq 64 \
        --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 3 --batch 2 --seq 64 --device cpu

The embedding mode in detail:

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
continues from it, bitwise-identical to an uninterrupted run. ``--inject
SPEC`` installs a deterministic fault plan (crash/delay/corrupt at the
``walk.chunk``, ``store.put``, ``disk.write`` and ``train.episode`` sites —
see ``repro_torch.runtime.faults``) for chaos testing; a crashed walk chunk
is retried (``WalkConfig.retries``), bitwise. ``--stall-timeout-s`` bounds
how long any stage may block without store progress before failing with
diagnostics instead of hanging. On any fatal exit the launcher writes
``OUT_DIR/diagnostics.json`` (the error, a stall's diagnostics, and the live
metrics when telemetry is on).

``--store disk`` is the paper's offline mode: episodes go through
checksummed ``.npy`` files under ``--store-dir`` (default OUT_DIR/samples),
byte for byte the JAX package's, deleted once consumed unless
``--keep-samples``; a torn or corrupt file is re-walked and rewritten, and
the epoch line says ``[N episode(s) re-walked]``. ``--metrics-dir`` writes
``metrics.jsonl`` and ``metrics_summary.json`` (walk, store, pipeline and
train histograms) and ``--trace FILE`` a Perfetto timeline of the walk,
store, build, stage and train lanes.

``--hbm-rows N`` trains through tiered tables (``core.tiered``): the full
tables in host RAM (``--cache-spill``: ``np.memmap`` files under
OUT_DIR/master_spill) and a device cache of the N hottest rows a table,
promoted by ``--cache-policy`` (freq or lru) at each episode's head; the
checkpoint is the resident run's bit for bit. It prints ``tiered tables:
...`` at the start and ``cache: hit_rate ...`` at the end, and runs on one
rank only.

``--remote-walkers N`` runs the walks in N producer processes
(``multiprocessing`` spawn; they import no torch, so they never touch the
card) that ship episode chunks to an episode server in the launcher over
the checksummed socket transport (``walk/remote.py``,
``runtime/transport.py``): the sample stream is bitwise the in-process
one. A producer whose heartbeat lease (``--lease-s``) lapses has its
episodes reassigned to the survivors; when every producer is dead the run
fails with the hosts named, and never walks in process instead.
``--coordinator-resume`` (with ``--resume``) builds the episode server in
recovery mode: it skips every episode the sample store already accepted
(``--store disk --keep-samples`` keeps them across the crash) and re-walks
the rest, bitwise. The launcher prints the JAX launcher's ``remote
walkers:``, ``coordinator takeover:``, ``transport:`` and ``failover:``
lines, and the summary and ``diagnostics.json`` gain the transport and
failover statistics.

Under several ranks, rank 0 keeps these paths, and rank r > 0 writes its
own samples, metrics, trace and diagnostics under a ``rank<r>/``
subdirectory of each (a trace ``dir/t.json`` becomes ``dir/rank<r>/t.json``):
every rank walks the same episodes, so they must not share one directory.
With ``--remote-walkers`` each rank runs its own episode server and
producers, listening on ``--coordinator-port`` + rank when that is nonzero.
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


def _rank_path(path, rank, file=False):
    """Rank r > 0's copy of a per-rank output path: ``path/rank<r>`` for a
    directory, ``dirname/rank<r>/basename`` for a file; rank 0 keeps
    ``path``."""
    if path is None or rank == 0:
        return path
    if file:
        head, tail = os.path.split(path)
        return os.path.join(head, f"rank{rank}", tail)
    return os.path.join(path, f"rank{rank}")


def train_embedding(args) -> dict:
    import torch.distributed as dist

    # fail before any graph work: the flags first, then the device
    if args.coordinator_resume and args.remote_walkers <= 0:
        raise SystemExit("--coordinator-resume requires --remote-walkers")
    if args.coordinator_resume and not args.resume:
        raise SystemExit("--coordinator-resume requires --resume (the "
                         "trainer cursor tells the server which epochs to "
                         "re-submit)")
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
    from repro_torch import obs

    say = print if rank == 0 else (lambda *a, **kw: None)
    metrics_dir = _rank_path(args.metrics_dir, rank)
    trace_path = _rank_path(args.trace, rank, file=True)

    # telemetry is opt-in (disabled-by-default hot paths are single None
    # checks); enable BEFORE building the dataflow so components register
    # their snapshot sources with the live registry
    writer = obs_tracer = None
    if metrics_dir or trace_path:
        reg = obs.enable()
        if trace_path:
            obs_tracer = obs.Tracer()
            obs.set_tracer(obs_tracer)
        if metrics_dir:
            writer = obs.MetricsWriter(reg, metrics_dir,
                                       interval_s=args.metrics_interval_s)
            say(f"metrics -> {writer.path} "
                f"(every {writer.interval_s:g}s)")
    try:
        return _train_dataflow(args, world, rank, device, say)
    finally:
        # on the way out, in the JAX launcher's order: close the writer,
        # save the trace, then switch the registry off
        if writer is not None:
            writer.close()
            say(f"metrics summary -> {writer.summary_path}")
        if obs_tracer is not None:
            obs.set_tracer(None)
            os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
            obs_tracer.save(trace_path)
            say(f"trace -> {trace_path} ({obs_tracer.event_count()} "
                f"events, {obs_tracer.dropped} dropped)")
        if writer is not None or obs_tracer is not None:
            obs.disable()


def _train_dataflow(args, world, rank, device, say) -> dict:
    from repro_torch.configs.tencent_embedding import SMALL
    from repro_torch.core import (EpisodePipeline, HybridConfig,
                                  HybridEmbeddingTrainer,
                                  TieredEmbeddingTrainer)
    from repro_torch.core import eval as ev
    from repro_torch.graph.csr import build_csr
    from repro_torch.graph.generators import powerlaw_graph, sbm_graph
    from repro_torch.runtime import FaultPlan, clear_plan, install_plan
    from repro_torch.train.checkpoint import load_arrays
    from repro_torch.walk import (DiskSampleStore, MemorySampleStore,
                                  RemoteWalkCoordinator, WalkConfig,
                                  WalkEngine)

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
    if args.hbm_rows is not None:
        # tiered tables: host-RAM master + a device cache of --hbm-rows hot
        # rows; bitwise the resident trainer at any budget, so the
        # artifacts (and --resume) are interchangeable between the two
        trainer = TieredEmbeddingTrainer(
            g.num_nodes, cfg, degrees=g.degrees(), hbm_rows=args.hbm_rows,
            policy=args.cache_policy,
            spill_dir=(os.path.join(args.out_dir, "master_spill")
                       if args.cache_spill else None),
            dims=(1, world), device=device)
        say(f"tiered tables: hbm_rows={args.hbm_rows} "
            f"policy={args.cache_policy}"
            + (" (disk-backed master)" if args.cache_spill else ""))
    else:
        trainer = HybridEmbeddingTrainer(g.num_nodes, cfg,
                                         degrees=g.degrees(),
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
            return {"auc": None, "edges": 0, "episodes": 0, "cache": None,
                    "transport": None, "failover": None}
    else:
        trainer.init_embeddings()

    # bounded store: the walker can run at most store_depth episodes ahead of
    # the pipeline's drops, so peak sample memory is O(depth · episode)
    store_depth = args.store_depth or args.pipeline_depth + 1
    store_kw = {}
    if args.stall_timeout_s is not None:
        store_kw["stall_timeout_s"] = (args.stall_timeout_s
                                       if args.stall_timeout_s > 0 else None)
    if args.store == "disk":
        # fresh: this run produces NEW walks — stale episode files or .done
        # markers from a previous run in the same dir would race it. With
        # --keep-samples the files are the artifact the user asked to keep,
        # so never delete them — warn instead if any are present.
        sample_dir = _rank_path(
            args.store_dir or os.path.join(args.out_dir, "samples"), rank)
        if args.keep_samples and os.path.isdir(sample_dir) and any(
                f.startswith("epoch") and f.endswith((".npy", ".done"))
                for f in os.listdir(sample_dir)):
            print(f"WARNING: {sample_dir} already holds episode files from a "
                  f"previous run; this run's epochs will overwrite same-"
                  f"numbered files and may race stale .done markers — use a "
                  f"fresh --store-dir to keep both artifacts")
        # --coordinator-resume reconstructs the episode server's state FROM
        # the store, so a resuming run must never wipe the surviving files
        keep_files = args.keep_samples or args.coordinator_resume
        store = DiskSampleStore(sample_dir, depth=store_depth,
                                keep=args.keep_samples,
                                fresh=not keep_files, **store_kw)
    else:
        store = MemorySampleStore(depth=store_depth, **store_kw)
    wcfg = WalkConfig(walk_length=10, window=5, episodes=args.episodes,
                      seed=args.seed, workers=args.walk_workers)
    # rewalk: a never-started engine whose episode_pairs regenerates any
    # episode bitwise — the corrupt-episode-file recovery path
    pipe = EpisodePipeline(store, trainer.part, pad_multiple=cfg.minibatch,
                           block_cap=args.block_cap,
                           depth=args.pipeline_depth,
                           stage_fn=trainer.stage_blocks,
                           device=trainer.device,
                           drop_consumed=True,
                           rewalk=WalkEngine(g, wcfg, store).episode_pairs)
    os.makedirs(args.out_dir, exist_ok=True)

    plan = None
    if args.inject:
        plan = FaultPlan(args.inject)
        install_plan(plan)
        say(f"fault plan: {args.inject}")

    # walker factory: the in-process threaded engine, or — with
    # --remote-walkers N — spawned producers shipping episode chunks over
    # the checksummed socket transport (same RNG keys, bitwise the same
    # sample stream, walks outside the training process's GIL). A rank
    # has its own server and producers: every rank walks every episode.
    coord = None
    try:
        if args.remote_walkers > 0:
            coord = RemoteWalkCoordinator(
                g, wcfg, store, num_producers=args.remote_walkers,
                heartbeat_s=args.heartbeat_s, lease_s=args.lease_s,
                inject_specs=args.inject,
                port=(args.coordinator_port + rank
                      if args.coordinator_port else 0),
                recover=args.coordinator_resume,
                server_grace_s=args.server_grace_s)
            coord.start()
            mk_walker = coord.epoch_walker
            say(f"remote walkers: {args.remote_walkers} subprocess "
                f"producer(s) @ {coord.server.address[0]}:"
                f"{coord.server.address[1]} (heartbeat {args.heartbeat_s}s, "
                f"lease {args.lease_s}s, grace {args.server_grace_s}s)")
            if args.coordinator_resume:
                say(f"coordinator takeover: recovering server on port "
                    f"{coord.server.address[1]} reconstructs epoch state "
                    f"from the {args.store} store")
        else:
            def mk_walker():
                return WalkEngine(g, wcfg, store)

        engine = mk_walker()
        engine.start_async(start_epoch)
        summary = _train_embedding_epochs(args, cfg, trainer, engine, store,
                                          pipe, test_e, neg_e,
                                          mk_walker=mk_walker,
                                          start_epoch=start_epoch,
                                          start_episode=start_episode,
                                          say=say)
        summary["cache"] = None
        if args.hbm_rows is not None:
            st = summary["cache"] = trainer.cache_stats()
            say(f"cache: hit_rate {st['hit_rate']:.3f} "
                f"hbm_bytes {st['hbm_bytes_moved']} "
                f"host_bytes {st['host_bytes_moved']} "
                f"promotions {st['vertex']['promotions']}"
                f"+{st['context']['promotions']} "
                f"evictions {st['vertex']['evictions']}"
                f"+{st['context']['evictions']}")
        summary["transport"] = summary["failover"] = None
        if coord is not None:
            st = summary["transport"] = coord.transport_stats()
            say(f"transport: {st['frames_recv']} frames / "
                f"{st['bytes_recv']} bytes received, "
                f"{st['dup_chunks']} duplicate chunk(s) discarded")
            fo = summary["failover"] = coord.failover_stats()
            if fo["takeovers"] or fo["recovered_episodes"]:
                say(f"failover: {fo['takeovers']} takeover(s), "
                    f"{fo['recovered_episodes']} episode(s) recovered "
                    f"from the store without re-production")
        return summary
    except BaseException as e:
        # leave a machine-readable dump on ANY fatal exit, so a chaos run
        # that dies on an unexpected error still produces an artifact: what
        # failed, what was resident, which hosts were (not) beating, and
        # the live metrics when telemetry is on
        _dump_diagnostics(_rank_path(args.out_dir, rank), e, coord)
        raise
    finally:
        # always drain the prefetch workers: an in-flight build racing
        # interpreter teardown can crash inside numpy after module unload;
        # then stop the producers, so no process or socket outlives the run
        pipe.close()
        if coord is not None:
            coord.close()
        if plan is not None:
            clear_plan()


def _dump_diagnostics(out_dir, err, coord):
    """OUT_DIR/diagnostics.json: the failure in machine-readable form, with
    the JAX launcher's keys (with remote walkers also the hosts' leases,
    the transport's and the failover's statistics)."""
    import json

    from repro_torch import obs
    from repro_torch.runtime import StoreStalled

    diag = {"error": type(err).__name__, "message": str(err)}
    if isinstance(err, StoreStalled):
        diag.update({"op": err.op, "key": err.key,
                     "resident": sorted(err.resident),
                     "producer_alive": err.producer_alive,
                     "producer_info": err.producer_info,
                     "waited_s": err.waited_s})
    if coord is not None:
        diag["host_health"] = coord.server.health.snapshot()
        diag["transport"] = coord.transport_stats()
        diag["failover"] = coord.failover_stats()
    reg = obs.active()
    if reg is not None:          # fold the live registry into the dump
        diag["metrics"] = reg.snapshot()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "diagnostics.json")
    with open(path, "w") as f:
        json.dump(diag, f, indent=2, default=str)
    print(f"diagnostics -> {path}")


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
    from repro_torch.obs import trace as _trace
    from repro_torch.runtime import fault_point
    from repro_torch.train.checkpoint import save_checkpoint

    auc = 0.0
    loss_s = "--"
    path = None
    edges, train_s, n_episodes = 0, 0.0, 0
    ckpt_every = max(0, args.ckpt_every)
    for epoch in range(start_epoch, args.epochs):
        # streamed: do NOT join — training starts as soon as episode 0 lands
        # in the bounded store; the walker streams the rest concurrently
        tr = _trace.tracer()
        t_epoch_us = tr.now_us() if tr is not None else 0.0
        t0 = time.perf_counter()
        nxt = None
        losses = []
        # resuming mid-epoch: episodes before the cursor were already trained
        # into the restored tables — drain them from the walker's stream
        # without training so the bounded store keeps flowing
        skip_until = start_episode if epoch == start_epoch else 0
        try:
            for ep in range(args.episodes):
                fault_point("train.episode", (epoch, ep))
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
        if tr is not None:
            tr.add_span("epoch", "train", t_epoch_us, tr.now_us(),
                        {"epoch": epoch, "auc": round(float(auc), 4)})
        loss_s = f"{np.mean(losses):.4f}" if losses else "--"
        say(f"epoch {epoch:3d} loss {loss_s} AUC {auc:.4f} "
            f"({time.perf_counter()-t0:.1f}s)"
            + (f" [{len(pipe.recovered)} episode(s) re-walked]"
               if pipe.recovered else ""))
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
            "episodes": n_episodes, "checkpoint": path, "ranks": ranks,
            "rewalked": list(pipe.recovered)}


def train_lm(args) -> dict:
    """The LM mode (the module docstring). Returns ``{"losses",
    "grad_norm", "params", "checkpoint", "step_s", "ranks",
    "collectives", "step_memory"}``: every step's loss and grad norm
    (floats), the trained parameters (under several ranks, this rank's
    shards), the ``lm_final.npz`` path (None without ``--save``), the
    mean seconds of a step after the first, the number of ranks, this
    rank's collectives over the steps (``collectives.COLLECTIVES``) and,
    on the card, what it held as the first step began and that step's
    peak (:func:`_memory_before`; None on the CPU). The card's peak stats
    are reset as the first step starts: the peak over the whole run is
    the larger of ``step_memory["peak_before"]`` and
    ``torch.cuda.max_memory_allocated()`` read after it."""
    import torch.distributed as dist

    world, rank, device, backend = _ranks(args)
    if backend is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                                 f"{os.environ['MASTER_PORT']}",
            world_size=world, rank=rank)
    try:
        return _train_lm(args, world, rank, device)
    finally:
        if backend is not None:
            dist.destroy_process_group()


def _train_lm(args, world, rank, dev) -> dict:
    import dataclasses

    import torch

    from repro_torch import collectives
    from repro_torch import configs as cfgs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.serve import require_fit
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import count_params
    from repro_torch.models.convert import params_to_jax
    from repro_torch.models.config import ModelConfig
    from repro_torch.sharding import param_shardings, shard
    from repro_torch.sharding.mesh import make_host_mesh
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.train_step import make_train_step

    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = cfgs.get_config(args.arch)
    if not isinstance(cfg, ModelConfig):
        raise SystemExit(f"--arch {args.arch} is not an LM")
    if args.reduced:
        cfg = cfg.reduced(layers=args.layers or 4, d_model=args.d_model,
                          experts=4)
        cfg = dataclasses.replace(
            cfg, vocab_size=min(cfg.vocab_size, 8192), train_microbatches=1)
    elif args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    tfm.check_family(cfg)
    require_fit(args.arch, cfg, dev)
    params = tfm.init_params(cfg, seed=args.seed, device=dev)
    say(f"{args.arch}: {count_params(params)/1e6:.1f}M params")

    if world > 1:
        # every rank makes the whole tree from the seed and keeps its
        # shards: the (1, ranks) mesh JAX's launcher builds
        mesh = make_host_mesh()
        specs = param_shardings(params, mesh, cfg)
        params = shard.shard_params(params, specs, mesh)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        step_fn, opt = make_train_step(cfg, lr=args.lr, mesh=mesh,
                                       specs=specs)
    else:
        # MoE layers take the expert dispatch: JAX's trainer runs under its
        # host mesh, which on one device routes them so
        step_fn, opt = make_train_step(cfg, lr=args.lr, moe_dispatch=True)
    opt_state = opt.init(params)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    positions = torch.arange(args.seq, dtype=torch.int32,
                             device=dev).expand(args.batch, args.seq)
    losses, norms, times = [], [], []
    step_memory = None
    collectives.reset_counts()
    try:
        for step in range(args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.next().items()}
            batch = dict(batch, positions=positions)
            if step == 0 and dev.type == "cuda":
                step_memory = _memory_before(torch, dev, params, opt_state,
                                             batch)
            params, opt_state, m = step_fn(params, opt_state, step, batch)
            if step_memory is not None and "step_peak" not in step_memory:
                torch.cuda.synchronize(dev)
                step_memory["step_peak"] = torch.cuda.max_memory_allocated(
                    dev)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"grad_norm {norms[-1]:.2f}")
    finally:
        pipe.close()
    sent = collectives.counts()
    path = None
    if args.save:
        path = os.path.join(args.out_dir, "lm_final.npz")
        whole = params if world == 1 else shard.gather_params(params, specs,
                                                              mesh)
        if rank == 0:
            save_checkpoint(path, params_to_jax(whole, cfg), step=args.steps)
        del whole
    later = times[1:] or times
    return {"losses": losses, "grad_norm": norms, "params": params,
            "checkpoint": path, "ranks": world, "collectives": sent,
            "step_s": sum(later) / len(later) if later else None,
            "step_memory": step_memory}


def _memory_before(torch, dev, params, opt_state, batch) -> dict:
    """What a rank on the card holds as the first step starts: the bytes
    of its parameter and optimizer-state shards and of the batch (each
    tensor's elements), the allocator's bytes in use and its peak so far;
    the peak is then reset, so that the step's own peak can be read after
    it (``step_peak``, added by the caller)."""
    from repro_torch.models.common import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    torch.cuda.synchronize(dev)
    mem = {"params": nbytes(params), "opt_state": nbytes(opt_state),
           "batch": nbytes(batch),
           "before": torch.cuda.memory_allocated(dev),
           "peak_before": torch.cuda.max_memory_allocated(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    return mem


def main(argv=None) -> dict:
    """Run the trainer. The embedding mode returns ``{"auc", "loss",
    "edges", "train_s", "edges_per_s", "episode_s", "episodes",
    "checkpoint", "ranks", "rewalked", "cache", "transport", "failover"}``
    (``cache``: the tiered trainer's ``cache_stats()`` with ``--hbm-rows``;
    ``transport`` and ``failover``: the remote walkers' statistics with
    ``--remote-walkers``; else None); the LM mode :func:`train_lm`'s
    summary."""
    from repro_torch.core.tiered import CACHE_POLICIES
    from repro_torch.kernels.ops import STEP_IMPLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tencent-embedding",
                    help="tencent-embedding (the paper's embedding trainer) "
                         "or an LM arch (the LM mode; --reduced cuts it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default 0.025 for the embedding "
                         "mode, 3e-4 for the LM mode)")
    # embedding mode
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
    ap.add_argument("--hbm-rows", type=int, default=None,
                    help="train through tiered tables: host-RAM master + a "
                         "device cache of this many hot rows per table "
                         "(core.tiered; bitwise identical to the resident "
                         "trainer at any budget; one rank only). Default: "
                         "fully resident tables")
    ap.add_argument("--cache-policy", default="freq",
                    choices=CACHE_POLICIES,
                    help="hot-row promotion policy for --hbm-rows: freq "
                         "(cumulative access count) or lru (most recent "
                         "episode touch); ties break to the smaller row id")
    ap.add_argument("--cache-spill", action="store_true",
                    help="with --hbm-rows: back the master tables with "
                         "np.memmap files under OUT_DIR/master_spill "
                         "(tables beyond host RAM)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="episodes between atomic resume checkpoints "
                         "(OUT_DIR/resume.npz: tables + cursor, crc-"
                         "manifested; 0 = final artifact only)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from OUT_DIR/resume.npz — restores tables "
                         "+ (epoch, episode) cursor and trains the rest of "
                         "the run")
    ap.add_argument("--inject", action="append", default=[], metavar="SPEC",
                    help="deterministic fault spec, repeatable: "
                         "site:kind[:opt=val]... e.g. walk.chunk:crash:at=5, "
                         "train.episode:crash:key=6/1, "
                         "disk.write:corrupt:at=0 (see "
                         "repro_torch.runtime.faults)")
    ap.add_argument("--stall-timeout-s", type=float, default=None,
                    help="seconds without sample-store progress before a "
                         "blocked stage fails with StoreStalled diagnostics "
                         "(default 600; <=0 disables the deadline — producer "
                         "liveness detection still applies)")
    ap.add_argument("--walk-workers", type=int, default=2,
                    help="walk-engine chunk worker threads (1 = inline; the "
                         "sample stream is identical for any value)")
    ap.add_argument("--remote-walkers", type=int, default=0,
                    help="run N walk producers as subprocesses shipping "
                         "episode chunks over the checksummed socket "
                         "transport (0 = in-process threads). The sample "
                         "stream is bitwise-identical either way; "
                         "subprocesses walk outside the GIL and survive "
                         "producer crashes via lease-based reassignment")
    ap.add_argument("--coordinator-resume", action="store_true",
                    help="with --resume and --remote-walkers: build the "
                         "episode server in recovery mode — it reconstructs "
                         "the work queue from the sample store (complete "
                         "episodes skipped, partial ones replayed via the "
                         "RNG keys) instead of starting the epoch from 0")
    ap.add_argument("--coordinator-port", type=int, default=0,
                    help="fixed listen port for the episode server (default "
                         "0 = ephemeral; rank r listens on this + r); a "
                         "restarted coordinator must reuse its "
                         "predecessor's port so producers in their "
                         "reconnect-backoff loop can reattach")
    ap.add_argument("--server-grace-s", type=float, default=30.0,
                    help="producer-side outage budget: how long a producer "
                         "keeps retrying (jittered capped backoff) against "
                         "an unreachable episode server before giving up")
    ap.add_argument("--heartbeat-s", type=float, default=1.0,
                    help="remote producer heartbeat interval")
    ap.add_argument("--lease-s", type=float, default=10.0,
                    help="seconds without a heartbeat before a remote "
                         "producer is declared dead and its unfinished "
                         "episodes are reassigned to survivors")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="episodes in flight through the fetch/build/stage "
                         "pipeline")
    ap.add_argument("--store", default="memory", choices=["memory", "disk"],
                    help="sample store backend (disk = the paper's "
                         "offline/slow-cluster mode: episode .npy files)")
    ap.add_argument("--store-dir", default=None,
                    help="disk-store directory (default: OUT_DIR/samples)")
    ap.add_argument("--store-depth", type=int, default=None,
                    help="bounded-store capacity in undrained episodes "
                         "(default: pipeline depth + 1)")
    ap.add_argument("--keep-samples", action="store_true",
                    help="disk store: keep episode files after consumption "
                         "(the offline artifact) instead of deleting them")
    ap.add_argument("--block-cap", type=int, default=None,
                    help="pin every episode's per-cell block capacity (rounds "
                         "up to the minibatch pad); samples past it are "
                         "dropped (default: per-episode max cell count)")
    ap.add_argument("--min-auc", type=float, default=None,
                    help="exit non-zero if the final epoch's link-prediction "
                         "AUC is below this (CI sanity gate)")
    # telemetry (repro_torch.obs; disabled unless one of these is given)
    ap.add_argument("--metrics-dir", default=None,
                    help="enable the telemetry registry and append periodic "
                         "snapshots to DIR/metrics.jsonl (+ final "
                         "metrics_summary.json at exit)")
    ap.add_argument("--metrics-interval-s", type=float, default=5.0,
                    help="seconds between metrics.jsonl snapshots")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a span timeline of the walk/build/stage/"
                         "train pipeline and write Chrome trace-event JSON "
                         "to FILE (load in ui.perfetto.dev)")
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
    # lm mode
    ap.add_argument("--reduced", action="store_true",
                    help="cut the LM to --layers layers of width --d-model "
                         "(4 experts, vocab <= 8192, one microbatch)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=None,
                    help="the LM's depth (default: the arch's; 4 with "
                         "--reduced)")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--save", action="store_true",
                    help="write OUT_DIR/lm_final.npz (the JAX tree layout)")
    args = ap.parse_args(argv)
    if args.arch == "tencent-embedding":
        args.lr = args.lr if args.lr is not None else 0.025
        return train_embedding(args)
    args.lr = args.lr if args.lr is not None else 3e-4
    return train_lm(args)


if __name__ == "__main__":
    main()
