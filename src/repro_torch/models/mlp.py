"""FFN layers: the gated dense MLP (SwiGLU) and the mixture of experts.

The port of the JAX package's ``models/mlp.py``. The MoE layer has two
routes, both computing top-k routing with renormalised gates and the
Switch-style load-balance loss:

* :func:`moe_ref`, the dense oracle: every expert computes every token and
  the gates pick k of them. It is what the JAX package runs without a mesh
  (``moe_forward(mesh=None)``), which is its serving path. The port runs it
  over blocks of tokens sized by :data:`MOE_REF_BLOCK_BYTES`, so that its
  (E, T, ff) and (E, T, d) intermediates fit beside deepseek-v3's weights
  (a 2,048-token chunk at 256 experts would make 19 GB of them in f32);
  each token's arithmetic is the same.
* the expert dispatch (``moe_forward(dispatch=True)``): JAX's
  ``_device_moe`` at one expert-parallel rank, which is what its trainer
  runs under the one-device host mesh. Each (token, choice) row takes a
  slot in a per-expert buffer of ``cap_e`` rows by its stable rank within
  its expert, in the flat ``t * k + j`` order; rows past the send capacity
  or past ``cap_e`` are dropped and contribute zero. The experts run as
  batched products on the ``(E, cap_e, d)`` buffer, and the rows combine
  back into their tokens by an f32 scatter-add weighted by the gates.
  Several ranks (the all-to-all) wait for ``sharding/``.

The JAX package computes the expert products outside any Pallas kernel;
so does the port (``torch.matmul``).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init
from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# dense gated FFN
# --------------------------------------------------------------------------
def init_ffn_params(gen: torch.Generator, d_model: int, d_ff: int, dtype, *,
                    device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), **kw),
        "w_up": dense_init(gen, (d_model, d_ff), **kw),
        "w_down": dense_init(gen, (d_ff, d_model), in_axis=0, **kw),
    }


def ffn_forward(params, x):
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def init_moe_params(gen: torch.Generator, cfg: ModelConfig, *,
                    device=None) -> dict:
    """The router (always f32), ``w_gate``/``w_up`` (E, d, ff), ``w_down``
    (E, ff, d), and the ``shared`` FFN of width ``moe_d_ff *
    moe_num_shared`` when the config has shared experts."""
    d, E, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    p = {
        "router": dense_init(gen, (d, E), dtype=torch.float32, device=device),
        "w_gate": dense_init(gen, (E, d, ff), **kw),
        "w_up": dense_init(gen, (E, d, ff), **kw),
        "w_down": dense_init(gen, (E, ff, d), in_axis=1, **kw),
    }
    if cfg.moe_num_shared:
        p["shared"] = init_ffn_params(gen, d, ff * cfg.moe_num_shared, dt,
                                      device=device)
    return p


def _route(x2, router, k: int):
    """Router probabilities (T, E) f32 and the top-k gates (T, k),
    renormalised, with their expert ids (T, k). Ties go to the lower expert
    id, as ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    probs = torch.softmax(x2.float() @ router, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = order.values[:, :k], order.indices[:, :k]
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def _gates(probs, topw, topi):
    """The dense (T, E) gate matrix: each row's top-k weights at its
    experts, zero elsewhere."""
    return torch.zeros_like(probs).scatter(1, topi, topw)


def _aux_loss(probs, gates, cfg: ModelConfig):
    """Switch-style load balance: E * Σ_e f_e · p̄_e, over every axis but
    the last (the experts)."""
    E = cfg.moe_num_experts
    dims = tuple(range(probs.ndim - 1))
    frac = (gates > 0).float().mean(dim=dims)
    pbar = probs.mean(dim=dims)
    return E * (frac * pbar).sum()


# bytes of a block's (E, T, ff) and (E, T, d) intermediates in moe_ref
MOE_REF_BLOCK_BYTES = 2 << 30


def moe_ref_block_tokens(cfg: ModelConfig, itemsize: int = 4) -> int:
    """Tokens a block of :func:`moe_ref`: its ``h`` (E, T, ff) and
    ``y_all`` (E, T, d) within :data:`MOE_REF_BLOCK_BYTES`."""
    per_token = cfg.moe_num_experts * (cfg.moe_d_ff + cfg.d_model) * itemsize
    return max(1, MOE_REF_BLOCK_BYTES // per_token)


def moe_ref(params, x, cfg: ModelConfig, *, block: int | None = None):
    """Dense oracle: every expert computes every token, gated combine, over
    blocks of ``block`` tokens (default :func:`moe_ref_block_tokens`).
    Returns (y in x's dtype, aux f32)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    probs, topw, topi = _route(xt, params["router"], cfg.moe_top_k)
    gates = _gates(probs, topw, topi)
    block = block or moe_ref_block_tokens(cfg, x.element_size())
    ys = []
    for i in range(0, T, block):
        xb = xt[i:i + block]
        h = torch.nn.functional.silu(torch.matmul(xb, params["w_gate"]))
        h = h * torch.matmul(xb, params["w_up"])           # (E, T_b, ff)
        y_all = torch.matmul(h, params["w_down"])          # (E, T_b, d)
        del h
        ys.append(torch.einsum("etd,te->td", y_all.float(),
                               gates[i:i + block]))
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    aux = _aux_loss(probs, gates, cfg)
    return y.reshape(B, S, d).to(x.dtype), aux


def _rank_in_group(group_ids, num_groups: int):
    """Rank of each element within its group (stable, 0-based), int64."""
    onehot = torch.nn.functional.one_hot(group_ids, num_groups)
    ranks = onehot.cumsum(dim=0) - 1
    return ranks.gather(1, group_ids[:, None])[:, 0]


def dispatch_plan(topi, cfg: ModelConfig):
    """Where each flat (token, choice) row ``r = t * k + j`` lands in the
    one-rank dispatch: ``(slot (R,) int64 into the flattened (E * cap_e)
    buffer, E * cap_e for a dropped row; kept (R,) bool; cap_e)``.

    JAX's ``_device_moe`` with one rank: ``cap_send = max(8, int(R *
    capacity_factor))`` send slots in flat order, then ``cap_e = max(8,
    ceil(cap_send / E))`` rows an expert by the row's stable rank within
    its expert; a row past either capacity is dropped."""
    E = cfg.moe_num_experts
    flat_e = topi.reshape(-1)
    R = flat_e.shape[0]
    cap_send = max(8, int(R * cfg.moe_capacity_factor))
    cap_e = max(8, -(-cap_send // E))
    rank_e = _rank_in_group(flat_e, E)
    r = torch.arange(R, device=flat_e.device)
    kept = (r < cap_send) & (rank_e < cap_e)
    slot = torch.where(kept, flat_e * cap_e + rank_e,
                       torch.full_like(rank_e, E * cap_e))
    return slot, kept, cap_e


def _moe_dispatch(params, x, cfg: ModelConfig):
    """One expert-parallel rank of JAX's ``_device_moe`` (the module
    docstring). Returns (y in x's dtype, aux f32)."""
    B, S, d = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, topw, topi = _route(xt, params["router"], k)
    slot, _, cap_e = dispatch_plan(topi, cfg)
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    # one spare row past the buffer takes every dropped row, then is cut
    buf = x.new_zeros((E * cap_e + 1, d)).index_copy(0, slot, xt[flat_tok])
    buf = buf[:-1].reshape(E, cap_e, d)
    h = torch.nn.functional.silu(torch.bmm(buf, params["w_gate"]))
    h = h * torch.bmm(buf, params["w_up"])
    y_buf = torch.bmm(h, params["w_down"]).reshape(E * cap_e, d)
    # a dropped row reads the zero row appended past the buffer
    y_rows = torch.cat([y_buf, y_buf.new_zeros((1, d))]).index_select(0, slot)
    contrib = y_rows.float() * topw.reshape(-1)[:, None]
    y = torch.zeros((T, d), dtype=torch.float32,
                    device=x.device).index_add(0, flat_tok, contrib)
    aux = _aux_loss(probs, _gates(probs, topw, topi), cfg)
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_forward(params, x, cfg: ModelConfig, *, dispatch: bool = False):
    """The MoE layer. ``dispatch=False`` is the dense oracle, as the JAX
    package computes without a mesh (its serving path; the shared experts
    are not added there). ``dispatch=True`` is the one-rank expert
    dispatch plus the shared experts, as JAX computes on a one-device mesh
    (its trainer's path)."""
    if not dispatch or cfg.moe_num_experts <= 1:
        return moe_ref(params, x, cfg)
    y, aux = _moe_dispatch(params, x, cfg)
    if "shared" in params:
        y = y + ffn_forward(params["shared"], x)
    return y, aux

