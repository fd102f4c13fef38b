"""Roofline terms of one rank's step on an H100, from the dry-run's counts
(no card is used).

The port's counterpart of the JAX package's ``launch/roofline.py``. The
hardware model is one NVIDIA H100 80GB HBM3 SXM5 at 700 W a rank, from
its published figures (spec, not measured):

* 989 TFLOP/s of dense bf16 on the tensor cores;
* 3.35 TB/s of HBM3;
* NVLink 4, 450 GB/s a direction a card, for a collective whose ranks all
  lie in one node of :data:`NODE_RANKS` ranks (``rank // 8``: torchrun's
  order, 8 cards a node);
* InfiniBand NDR, 50 GB/s a card, for one whose ranks span nodes.

Terms: compute = the rank's operations / the bf16 peak; memory = its
bytes (unfused: an upper bound) / the HBM rate; collective = each
collective's bytes (what the rank sends, counted by kind and group in
``sharding/shard.py``) over its link's rate, summed. A ring all-reduce
moves about twice its payload; the raw sum is reported, as JAX's does.
:func:`model_flops` and :func:`active_params` are JAX's, verbatim.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM5 (spec)
HBM_BW = 3.35e12             # bytes/s, HBM3 (spec)
NVLINK_BW = 450e9            # bytes/s a direction a card, NVLink 4 (spec)
IB_BW = 50e9                 # bytes/s a card, InfiniBand NDR 400 Gb/s (spec)
NODE_RANKS = 8               # cards (ranks) a node
HARDWARE = ("H100 80GB HBM3 SXM5, 700 W (spec, not measured): "
            "989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, NVLink 4 450 GB/s a "
            "direction a card inside a node of 8, InfiniBand NDR 50 GB/s "
            "a card across nodes")


def link_of(ranks) -> str:
    """``"nvlink"`` when every rank of a group lies in one node, else
    ``"ib"``."""
    return "nvlink" if len({r // NODE_RANKS for r in ranks}) == 1 else "ib"


def roofline_terms(flops: float, bytes_accessed: float,
                   group_bytes: dict) -> dict:
    """The three terms (seconds) and the dominant one; ``group_bytes``:
    ``{(kind, ranks): bytes}`` (``collectives.GROUP_BYTES``). Also the bytes that
    crossed each link and the links the collective term used."""
    by_link = {"nvlink": 0, "ib": 0}
    for (_, ranks), n in group_bytes.items():
        by_link[link_of(ranks)] += n
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = by_link["nvlink"] / NVLINK_BW + by_link["ib"] / IB_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["link_bytes"] = by_link
    terms["links"] = "+".join(k for k, v in by_link.items() if v) or "none"
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference).

    Embedding arch: the "model" touched per sample is two d-vectors per
    (pair x (1 + negatives)) — 6*2d per trained pair, not 6*N_total."""
    if getattr(cfg, "arch_type", "") == "embedding":
        # samples per episode: filled in by the caller via shape.global_batch?
        # use block geometry: P^2 * k * block_cap samples
        samples = 256 * 256 * cfg.subparts * cfg.block_cap
        return 6.0 * 2 * cfg.dim * (1 + cfg.negatives) * samples
    n_active = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg) -> float:
    """Forward-active parameter count (MoE: top_k + shared experts only)."""
    if getattr(cfg, "arch_type", "") == "embedding":
        return 2.0 * cfg.num_nodes * cfg.dim
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    hd = cfg.resolved_head_dim
    total = 2 * V * d  # embed + head
    types = cfg.layer_types()
    for i in range(L):
        if types[i] == "A":
            if cfg.mla:
                qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                total += (d * cfg.q_lora_rank
                          + cfg.q_lora_rank * cfg.num_heads * qk
                          + d * cfg.kv_lora_rank + d * cfg.qk_rope_head_dim
                          + cfg.kv_lora_rank * cfg.num_heads
                          * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                          + cfg.num_heads * cfg.v_head_dim * d)
            else:
                total += d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) \
                    + cfg.num_heads * hd * d
        else:
            di = cfg.d_inner_ssm
            total += d * (2 * di + 2 * cfg.ssm_state + cfg.ssm_heads) + di * d
        if cfg.is_moe_layer(i):
            active_e = cfg.moe_top_k + cfg.moe_num_shared
            total += 3 * d * cfg.moe_d_ff * active_e + d * cfg.moe_num_experts
        elif cfg.d_ff:
            total += 3 * d * cfg.d_ff
    if cfg.is_encdec:
        total += cfg.encoder_layers * (
            d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
            + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
        total += L * (d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
                      + cfg.num_heads * hd * d)  # cross-attention
    return float(total)
