"""Synthetic-but-structured token pipeline for the LM trainer.

A copy of the JAX package's ``data/tokens.py``, numpy only, so one seed
gives the same batches in both packages bit for bit. Generates documents
from a small order-1 Markov chain over the vocab so the LM has actual
structure to learn (loss visibly decreases), packs them into fixed-length
sequences, and prefetches batches on a worker thread — the same
producer/consumer decoupling the paper uses between its walk engine and
trainer. A vision config's batches also hold ``frontend_len_cap`` patch
embeddings a row, an audio config's ``seq`` encoder frames a row (both
N(0, 1), f32, drawn after the tokens from the same generator).
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.models.config import ModelConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, states: int = 64, prefetch: int = 2):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        rng = np.random.default_rng(seed)
        V = cfg.vocab_size
        self._states = states
        # sparse-ish Markov transition over `states` latent states, each
        # emitting a zipf-weighted slice of the vocab
        self._trans = rng.dirichlet(np.full(states, 0.3), size=states)
        emit = rng.zipf(1.4, size=(states, 32))
        self._emit = np.minimum(emit + np.arange(states)[:, None] * 17,
                                V - 1).astype(np.int32)
        self._rng = rng
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _sample(self):
        B, S = self.batch, self.seq
        rng = self._rng
        st = rng.integers(0, self._states, B)
        toks = np.zeros((B, S), np.int32)
        for t in range(S):
            # vectorized markov step
            u = rng.random(B)
            cdf = np.cumsum(self._trans[st], axis=1)
            st = (u[:, None] < cdf).argmax(axis=1)
            toks[:, t] = self._emit[st, rng.integers(0, 32, B)]
        out = {"tokens": toks}
        if self.cfg.modality == "vision":
            P = self.cfg.frontend_len_cap
            out["patch_embeds"] = rng.normal(
                0, 1, (B, P, self.cfg.d_model)).astype(np.float32)
        if self.cfg.modality == "audio":
            out["frames"] = rng.normal(
                0, 1, (B, S, self.cfg.d_model)).astype(np.float32)
        return out

    def _worker(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._sample(), timeout=1.0)
            except queue.Full:
                continue

    def next(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
