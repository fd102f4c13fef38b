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
* on a mesh (``moe_forward(mesh=)``), that dispatch over M ranks, as
  JAX's ``_device_moe`` computes it in its ``shard_map``: each rank
  routes its tokens (its sequence slice, or in quota mode its share of
  replicated tokens), sends each row to the rank of its expert over
  ``all_to_all`` (``send_plan``: ``cap_send`` slots a rank, in the flat
  ``t * k + j`` order), buckets what it receives by local expert
  (``recv_plan``: ``cap_e`` rows each), runs its experts and sends the
  rows back. The M = 1 case is the dispatch above (``dispatch_plan``);
  :func:`moe_ep_plain` runs every rank of a mesh in one process, the
  all-to-alls done by index arithmetic.

The JAX package computes the expert products outside any Pallas kernel;
so does the port (``torch.matmul``).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.models.common import dense_init
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard


# --------------------------------------------------------------------------
# dense gated FFN
# --------------------------------------------------------------------------
def init_ffn_params(key, d_model: int, d_ff: int, dtype, *,
                    device=None) -> dict:
    """The gated FFN from ``split(key, 3)``, as JAX's."""
    kw = dict(dtype=dtype, device=device)
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": dense_init(k1, (d_model, d_ff), **kw),
        "w_up": dense_init(k2, (d_model, d_ff), **kw),
        "w_down": dense_init(k3, (d_ff, d_model), in_axis=0, **kw),
    }


def ffn_forward(params, x):
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def init_moe_params(key, cfg: ModelConfig, *, device=None) -> dict:
    """The router (always f32), ``w_gate``/``w_up`` (E, d, ff), ``w_down``
    (E, ff, d), and the ``shared`` FFN of width ``moe_d_ff *
    moe_num_shared`` when the config has shared experts, from ``split(key,
    5)`` as JAX's."""
    d, E, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    ks = prng.split(key, 5)
    p = {
        "router": dense_init(ks[0], (d, E), dtype=torch.float32,
                             device=device),
        "w_gate": dense_init(ks[1], (E, d, ff), **kw),
        "w_up": dense_init(ks[2], (E, d, ff), **kw),
        "w_down": dense_init(ks[3], (E, ff, d), in_axis=1, **kw),
    }
    if cfg.moe_num_shared:
        p["shared"] = init_ffn_params(ks[4], d, ff * cfg.moe_num_shared, dt,
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


def _aux_loss(probs, gates, cfg: ModelConfig, mesh=None):
    """Switch-style load balance: E * Σ_e f_e · p̄_e, over every axis but
    the last (the experts); with ``mesh``, f and p̄ are means over the
    global batch (this rank's means averaged over ``mesh.b_axes``)."""
    E = cfg.moe_num_experts
    dims = tuple(range(probs.ndim - 1))
    frac = (gates > 0).float().mean(dim=dims)
    pbar = probs.mean(dim=dims)
    if mesh is not None and mesh.b_axes:
        n = mesh.axis_size(mesh.b_axes)
        frac = shard.all_reduce(frac, mesh, mesh.b_axes) / n
        pbar = shard.all_reduce(pbar, mesh, mesh.b_axes) / n
    return E * (frac * pbar).sum()


# bytes of a block's (E, T, ff) and (E, T, d) intermediates in moe_ref
MOE_REF_BLOCK_BYTES = 2 << 30


def moe_ref_block_tokens(cfg: ModelConfig, itemsize: int = 4) -> int:
    """Tokens a block of :func:`moe_ref`: its ``h`` (E, T, ff) and
    ``y_all`` (E, T, d) within :data:`MOE_REF_BLOCK_BYTES`."""
    per_token = cfg.moe_num_experts * (cfg.moe_d_ff + cfg.d_model) * itemsize
    return max(1, MOE_REF_BLOCK_BYTES // per_token)


def moe_ref(params, x, cfg: ModelConfig, *, block: int | None = None,
            mesh=None):
    """Dense oracle: every expert computes every token, gated combine, over
    blocks of ``block`` tokens (default :func:`moe_ref_block_tokens`).
    Returns (y in x's dtype, aux f32; with ``mesh``, over the global
    batch)."""
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
    aux = _aux_loss(probs, gates, cfg, mesh)
    return y.reshape(B, S, d).to(x.dtype), aux


def _rank_in_group(group_ids, num_groups: int):
    """Rank of each element within its group (stable, 0-based), int64."""
    onehot = torch.nn.functional.one_hot(group_ids, num_groups)
    ranks = onehot.cumsum(dim=0) - 1
    return ranks.gather(1, group_ids[:, None])[:, 0]


# --------------------------------------------------------------------------
# the expert-parallel dispatch over M ranks (JAX's _device_moe)
# --------------------------------------------------------------------------
def ffn_sharded(params, x, mesh, spec):
    """:func:`ffn_forward` on this rank's shards: column-parallel
    ``w_gate``/``w_up`` and row-parallel ``w_down`` (summed over "model")
    where the FFN width is sharded over "model", else the weights gathered
    whole."""
    p, split = shard.block_view(params, spec, mesh, shard.FFN_DIMS)
    y = ffn_forward(p, x)
    return shard.all_reduce(y, mesh, "model") if split else y


# the expert-parallel dispatch's rows: routed and dropped (past the send
# capacity or past an expert's), counted while a caller sets this to a dict
# (each plan then syncs once)
EP_ROWS = None


def _count_rows(routed, dropped) -> None:
    EP_ROWS["routed"] = EP_ROWS.get("routed", 0) + int(routed)
    EP_ROWS["dropped"] = EP_ROWS.get("dropped", 0) + int(dropped)


def send_plan(topi, cfg: ModelConfig, M: int, E_loc: int, *, m_idx: int = 0,
              quota: int | None = None):
    """One rank's send side over ``M`` expert-parallel ranks: each flat
    (token, choice) row ``r = t * k + j`` goes to rank ``e // E_loc`` at
    its stable rank among the rows bound there, into ``cap_send`` slots a
    rank. Returns ``(slot (R,) into the flattened (M * cap_send) send
    buffer, M * cap_send for a dropped row; local expert id (R,);
    cap_send)``. In quota mode only the rows of this rank's ``quota``
    tokens are sent."""
    k = cfg.moe_top_k
    flat_e = topi.reshape(-1)
    R = flat_e.shape[0]
    E = E_loc * M
    if quota is not None:
        tok = torch.arange(R, device=flat_e.device) // k
        mine = (tok >= m_idx * quota) & (tok < (m_idx + 1) * quota)
        flat_e = torch.where(mine, flat_e, torch.full_like(flat_e, E))
    dest = torch.clamp(flat_e // E_loc, max=M)
    cap_send = max(8, int(-(-(quota * k if quota else R) // M)
                          * cfg.moe_capacity_factor))
    rank_d = _rank_in_group(dest, M + 1)
    ok = (rank_d < cap_send) & (dest < M)
    if EP_ROWS is not None:
        _count_rows((dest < M).sum(), ((dest < M) & ~ok).sum())
    slot = torch.where(ok, dest * cap_send + rank_d,
                       torch.full_like(rank_d, M * cap_send))
    return slot, flat_e % E_loc, cap_send


def recv_plan(recv_e, E_loc: int):
    """The receive side: rows ``recv_e`` (local expert id, -1 for an empty
    slot) in send-slot order take a slot in a per-expert buffer of ``cap_e
    = max(8, ceil(Rr / E_loc))`` rows by their stable rank within their
    expert. Returns ``(slot (Rr,) into the flattened (E_loc * cap_e)
    buffer, E_loc * cap_e for an empty or dropped row; cap_e)``."""
    Rr = recv_e.shape[0]
    valid = recv_e >= 0
    cap_e = max(8, -(-Rr // E_loc))
    rank_e = _rank_in_group(torch.where(valid, recv_e,
                                        torch.full_like(recv_e, E_loc)),
                            E_loc + 1)
    ok = valid & (rank_e < cap_e)
    if EP_ROWS is not None:
        _count_rows(0, (valid & ~ok).sum())
    slot = torch.where(ok, recv_e * cap_e + rank_e,
                       torch.full_like(rank_e, E_loc * cap_e))
    return slot, cap_e


def dispatch_plan(topi, cfg: ModelConfig):
    """Where each flat (token, choice) row ``r = t * k + j`` lands in the
    one-rank dispatch, the M = 1 case of :func:`send_plan` and
    :func:`recv_plan`: ``(slot (R,) int64 into the flattened (E * cap_e)
    buffer, E * cap_e for a dropped row; kept (R,) bool; cap_e)``.

    JAX's ``_device_moe`` with one rank: ``cap_send = max(8, int(R *
    capacity_factor))`` send slots in flat order, then ``cap_e = max(8,
    ceil(cap_send / E))`` rows an expert by the row's stable rank within
    its expert; a row past either capacity is dropped."""
    E = cfg.moe_num_experts
    send, local_e, cap_send = send_plan(topi, cfg, 1, E)
    recv_e = torch.full((cap_send + 1,), -1, dtype=local_e.dtype,
                        device=local_e.device).index_copy(0, send, local_e)
    recv, cap_e = recv_plan(recv_e[:-1], E)
    spare = torch.full((1,), E * cap_e, dtype=recv.dtype, device=recv.device)
    slot = torch.cat([recv, spare]).index_select(0, send)
    return slot, slot < E * cap_e, cap_e


def _scatter_rows(rows, slot, n: int):
    """(n, d) rows placed at ``slot`` (a slot ``n`` is dropped); zero
    elsewhere."""
    return rows.new_zeros((n + 1, rows.shape[1])).index_copy(
        0, slot, rows)[:-1]


def _gather_rows(buf, slot):
    """Row ``slot[i]`` of ``buf``, zero where ``slot`` is past its end."""
    return torch.cat([buf, buf.new_zeros((1, buf.shape[1]))]).index_select(
        0, slot)


def _experts(params, buf):
    """The batched expert products on an (E_loc, cap, d) buffer."""
    h = torch.nn.functional.silu(torch.bmm(buf, params["w_gate"]))
    h = h * torch.bmm(buf, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _ep_send(params, x, cfg, M, m_idx, quota):
    """Route one rank's tokens and fill its send buffer. Returns (send rows
    (M * cap_send, d), their local expert ids (M * cap_send,), the state
    the combine needs)."""
    B, S, d = x.shape
    k = cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    E_loc = params["w_gate"].shape[0]
    probs, topw, topi = _route(xt, params["router"], k)
    slot, local_e, cap_send = send_plan(topi, cfg, M, E_loc, m_idx=m_idx,
                                        quota=quota)
    n = M * cap_send
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    send_x = _scatter_rows(xt[flat_tok], slot, n)
    send_e = torch.full((n + 1,), -1, dtype=local_e.dtype,
                        device=x.device).index_copy(0, slot, local_e)[:-1]
    aux = _aux_loss(probs, _gates(probs, topw, topi), cfg)
    return send_x, send_e, (slot, flat_tok, topw, T, aux)


def _ep_experts(params, recv_x, recv_e):
    """One rank's received rows through its local experts; the results in
    the received rows' order (zero for empty and dropped rows)."""
    E_loc, d = params["w_gate"].shape[0], recv_x.shape[1]
    slot, cap_e = recv_plan(recv_e, E_loc)
    buf = _scatter_rows(recv_x, slot, E_loc * cap_e).reshape(E_loc, cap_e, d)
    return _gather_rows(_experts(params, buf).reshape(E_loc * cap_e, d), slot)


def _ep_combine(back, state, shape, dtype):
    """The returned rows back into their tokens, weighted by the gates, in
    f32."""
    slot, flat_tok, topw, T, _ = state
    contrib = _gather_rows(back, slot).float() * topw.reshape(-1)[:, None]
    y = torch.zeros((T, back.shape[1]), dtype=torch.float32,
                    device=back.device).index_add(0, flat_tok, contrib)
    return y.reshape(shape).to(dtype)


def _moe_dispatch(params, x, cfg: ModelConfig):
    """One expert-parallel rank of JAX's ``_device_moe`` (the module
    docstring). Returns (y in x's dtype, aux f32)."""
    send_x, send_e, state = _ep_send(params, x, cfg, 1, 0, None)
    back = _ep_experts(params, send_x, send_e)
    return _ep_combine(back, state, x.shape, x.dtype), state[-1]


def ep_layout(cfg: ModelConfig, mesh, B: int, S: int):
    """JAX's ``moe_forward`` choices for a global batch of B x S tokens:
    (ep_axes, the batch axes, quota or None). ``ep_axes`` is (*data axes,
    "model") when the experts divide the whole mesh and the batch covers
    the data axes, else ("model",); ``quota`` when S does not divide over
    "model" (decode): tokens replicated over "model", rank m owning
    ``[m * quota, (m + 1) * quota)`` of its batch slice's tokens."""
    import numpy as np

    model_n = mesh.shape["model"]
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    b_axes: tuple = ()
    for kk in range(len(data_axes), 0, -1):
        n = int(np.prod([mesh.shape[a] for a in data_axes[:kk]]))
        if B % n == 0 and n > 1:
            b_axes = data_axes[:kk]
            break
    B_loc = B // int(np.prod([mesh.shape[a] for a in b_axes])) \
        if b_axes else B
    total = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if cfg.moe_num_experts % total == 0 and tuple(b_axes) == data_axes:
        ep_axes = (*data_axes, "model")
    else:
        ep_axes = ("model",)
    if S % model_n == 0:
        return ep_axes, b_axes, None
    return ("model",), b_axes, max(1, -(-(B_loc * S) // model_n))


def _moe_ep(params, spec, x, cfg: ModelConfig, mesh):
    """The expert-parallel MoE on this rank (``mesh``, ``b_axes`` set):
    x (B_loc, S, d) replicated over "model". Returns (y, aux averaged over
    the whole mesh)."""
    B = x.shape[0] * mesh.axis_size(mesh.b_axes)
    S = x.shape[1]
    ep_axes, _, quota = ep_layout(cfg, mesh, B, S)
    g = mesh.group(ep_axes)
    p = {n: shard.to_layout(params[n], spec[n],
                            shard.P(ep_axes) if n != "router" else shard.P(),
                            mesh)
         for n in ("router", "w_gate", "w_up", "w_down")}
    xs = x if quota is not None else shard.block_of(x, mesh, "model", 1)
    send_x, send_e, state = _ep_send(p, xs, cfg, g.size, g.index, quota)
    recv_x = shard.all_to_all(send_x, mesh, ep_axes)
    recv_e = shard.all_to_all_(send_e, mesh, ep_axes)
    back = shard.all_to_all(_ep_experts(p, recv_x, recv_e), mesh, ep_axes)
    y = _ep_combine(back, state, xs.shape, x.dtype)
    if quota is not None:
        y = shard.all_reduce(y, mesh, "model")
    else:
        y = shard.all_gather(y, mesh, "model", 1)
    aux = shard.all_reduce(state[-1], mesh, mesh.axis_names) / mesh.size
    return y, aux


def moe_ep_plain(params, x, cfg: ModelConfig, mesh):
    """The expert-parallel MoE of every rank of a (duck) ``mesh`` in one
    process, the all-to-alls done by index arithmetic: the plain version
    the ranks are held against. ``params`` whole, x the global (B, S, d).
    Returns (y, aux averaged over the mesh's ranks)."""
    import itertools

    import numpy as np

    B, S, d = x.shape
    ep_axes, b_axes, quota = ep_layout(cfg, mesh, B, S)
    names = tuple(mesh.axis_names)
    dims = [mesh.shape[a] for a in names]
    n_b = int(np.prod([mesh.shape[a] for a in b_axes])) if b_axes else 1
    M = int(np.prod([mesh.shape[a] for a in ep_axes]))
    model_n = mesh.shape["model"]
    E_loc = cfg.moe_num_experts // M

    def flat(c, axes):
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + c[a]
        return i

    coords = [dict(zip(names, c)) for c in itertools.product(
        *(range(n) for n in dims))]
    groups: dict = {}
    for c in coords:
        key = tuple(c[a] for a in names if a not in ep_axes)
        groups.setdefault(key, []).append(c)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=x.device)
    aux = []
    for members in groups.values():
        members.sort(key=lambda c: flat(c, ep_axes))
        sends, states, slices = [], [], []
        for c in members:
            m = flat(c, ep_axes)
            bi = flat(c, b_axes) if b_axes else 0
            rows = slice(bi * B // n_b, (bi + 1) * B // n_b)
            cols = slice(None) if quota is not None else slice(
                c["model"] * S // model_n, (c["model"] + 1) * S // model_n)
            experts = {n: params[n][m * E_loc:(m + 1) * E_loc]
                       for n in ("w_gate", "w_up", "w_down")}
            p = dict(experts, router=params["router"])
            send_x, send_e, state = _ep_send(p, x[rows, cols], cfg, M, m,
                                             quota)
            sends.append((send_x.reshape(M, -1, d), send_e.reshape(M, -1)))
            states.append((p, state))
            slices.append((rows, cols))
            aux.append(state[-1])
        # rank j receives block j of every rank's send buffer, in rank order
        outs = []
        for j, (p, _) in enumerate(states):
            rx = torch.cat([sx[j] for sx, _ in sends])
            re = torch.cat([se[j] for _, se in sends])
            outs.append(_ep_experts(p, rx, re).reshape(M, -1, d))
        for i, ((p, state), (rows, cols)) in enumerate(zip(states, slices)):
            back = torch.cat([outs[j][i] for j in range(M)])
            shape = x[rows, cols].shape
            y[rows, cols] += _ep_combine(back, state, shape,
                                         torch.float32)
    # quota mode: every "model" rank of a group adds its tokens; the
    # combined-axis groups each cover their own rows once
    reps = int(np.prod([mesh.shape[a] for a in names
                        if a not in ep_axes and a not in b_axes]))
    y = y / reps
    return y.to(x.dtype), torch.stack(aux).mean()


def moe_forward(params, x, cfg: ModelConfig, *, dispatch: bool = False,
                mesh=None, spec=None):
    """The MoE layer. ``dispatch=False`` is the dense oracle, as the JAX
    package computes without a mesh (its serving path; the shared experts
    are not added there). ``dispatch=True`` is the one-rank expert
    dispatch plus the shared experts, as JAX computes on a one-device mesh
    (its trainer's path); ``dispatch`` a (duck) mesh: the expert-parallel
    dispatch of every rank of that mesh in one process (:func:`moe_ep_plain`)
    plus the shared experts, what the ranks compute. ``mesh`` (with the layer's ``spec``): the
    expert-parallel dispatch over this rank's mesh, plus the shared experts
    (``ffn_sharded``); where the experts do not divide the "model" axis,
    the dense oracle on the gathered weights, as JAX falls back."""
    if mesh is not None and cfg.moe_num_experts > 1:
        if cfg.moe_num_experts % mesh.shape["model"] != 0:
            return moe_ref(shard.whole_tree(
                {n: params[n] for n in params if n != "shared"},
                spec, mesh), x, cfg, mesh=mesh)
        y, aux = _moe_ep(params, spec, x, cfg, mesh)
        if "shared" in params:
            y = y + ffn_sharded(params["shared"], x, mesh, spec["shared"])
        return y, aux
    if not dispatch or cfg.moe_num_experts <= 1:
        return moe_ref(params, x, cfg)
    if dispatch is True:
        y, aux = _moe_dispatch(params, x, cfg)
    else:
        y, aux = moe_ep_plain(params, x, cfg, dispatch)
    if "shared" in params:
        y = y + ffn_forward(params["shared"], x)
    return y, aux
