"""Evaluation utilities: link-prediction AUC (paper §V-B, Tables IV/V).

A numpy copy of the JAX package's ``core/eval.py``.

Following the paper (which follows GraphVite): score a node pair by the dot
product of the **vertex** embedding of the source and the **context**
embedding of the destination; AUC over held-out positive edges vs. uniformly
sampled non-edge node pairs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def split_edges(graph: CSRGraph, test_frac: float, *, seed: int = 0):
    """Split the (directed) edge list into train/test; returns (train_edges,
    test_edges). Symmetrized duplicates are kept together by splitting on
    canonical (min, max) keys."""
    edges = graph.edge_list()
    canon = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64) * graph.num_nodes \
        + np.maximum(edges[:, 0], edges[:, 1])
    uniq = np.unique(canon)
    rng = np.random.default_rng(seed)
    test_keys = rng.choice(uniq, size=max(1, int(len(uniq) * test_frac)),
                           replace=False)
    is_test = np.isin(canon, test_keys)
    return edges[~is_test], edges[is_test]


def sample_negative_pairs(graph: CSRGraph, num: int, *, seed: int = 0) -> np.ndarray:
    """Random node pairs that are not edges (rejection sampling)."""
    rng = np.random.default_rng(seed)
    out = []
    need = num
    edge_keys = (graph.edge_list()[:, 0].astype(np.int64) * graph.num_nodes
                 + graph.edge_list()[:, 1])
    edge_keys = np.sort(edge_keys)
    while need > 0:
        cand = rng.integers(0, graph.num_nodes, size=(2 * need, 2))
        cand = cand[cand[:, 0] != cand[:, 1]]
        keys = cand[:, 0].astype(np.int64) * graph.num_nodes + cand[:, 1]
        pos = np.searchsorted(edge_keys, keys)
        pos = np.minimum(pos, edge_keys.size - 1)
        ok = edge_keys[pos] != keys
        cand = cand[ok][:need]
        out.append(cand)
        need -= len(cand)
    return np.concatenate(out, axis=0)


def auc_score(pos_scores: np.ndarray, neg_scores: np.ndarray) -> float:
    """Rank-based AUC (exact, ties get 0.5 credit)."""
    scores = np.concatenate([pos_scores, neg_scores])
    labels = np.concatenate([np.ones(len(pos_scores)), np.zeros(len(neg_scores))])
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    # average ranks for ties
    sorted_scores = scores[order]
    ranks[order] = np.arange(1, len(scores) + 1)
    # tie correction
    i = 0
    sr = sorted_scores
    while i < len(sr):
        j = i
        while j + 1 < len(sr) and sr[j + 1] == sr[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_pos, n_neg = len(pos_scores), len(neg_scores)
    return float((ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def link_prediction_auc(vert: np.ndarray, ctx: np.ndarray,
                        pos_edges: np.ndarray, neg_edges: np.ndarray) -> float:
    def score(pairs):
        return np.einsum("ij,ij->i", vert[pairs[:, 0]], ctx[pairs[:, 1]])
    return auc_score(score(pos_edges), score(neg_edges))
