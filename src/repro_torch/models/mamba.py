"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

The port of the JAX package's ``models/mamba.py``, plain functions on
tensors. Chunked SSD: the within-chunk term through the 1-semiseparable
mask, the across-chunk recurrence on the (H, P, N) state carried by a loop
over the chunks (JAX's ``lax.scan``). Decode is the O(1) recurrent update
on the same state. The SSD runs in f32 whatever the parameter dtype;
``A_log``, ``D`` and ``dt_bias`` are always f32. JAX computes all of it
outside any Pallas kernel, and so does the port.

Parameters (the JAX layout): ``in_proj`` (d, 2 di + 2 N + H) emitting
[z, x, B, C, dt], ``conv_w`` (K, di + 2 N), ``conv_b``, ``A_log``, ``D``,
``dt_bias`` (H,), ``norm`` (di,), ``out_proj`` (di, d). A cache is
``{"state": (B, H, P, N), "conv": (B, K - 1, di + 2 N)}``, f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.config import ModelConfig


def init_mamba_params(key, cfg: ModelConfig, *, device=None) -> dict:
    """The mixer's leaves, its projections from ``split(key, 6)`` as
    JAX's."""
    d, di = cfg.d_model, cfg.d_inner_ssm
    H, N = cfg.ssm_heads, cfg.ssm_state
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ks = prng.split(key, 6)
    return {
        "in_proj": dense_init(ks[0], (d, 2 * di + 2 * N + H), **kw),
        "conv_w": dense_init(ks[1], (cfg.ssm_conv, di + 2 * N), **kw),
        "conv_b": torch.zeros((di + 2 * N,), **kw),
        "A_log": torch.zeros((H,), **f32),             # A = -exp(A_log)
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),      # softplus ~ 0.12
        "norm": torch.ones((di,), **kw),
        "out_proj": dense_init(ks[2], (di, d), in_axis=0, **kw),
    }


def _segsum(x):
    """Stable segment sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] for j
    <= i, -inf above the diagonal. The mask goes on before any ``exp``:
    the differences above it grow with the chunk and would overflow."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, float("-inf"))


def ssd_chunked(x, dt, A, B, C, *, chunk: int, init_state=None):
    """SSD scan. x: (b, S, H, P), dt: (b, S, H) (post-softplus), A: (H,)
    (< 0), B and C: (b, S, N). Returns (y (b, S, H, P), final state (b, H,
    P, N)). S is padded up to a multiple of ``chunk`` with zeros, which
    leave the state as it is."""
    b, S, H, Pd = x.shape
    N = B.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B, C))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, H, Pd)
    dtc = dt.reshape(b, nc, chunk, H)
    Bc = B.reshape(b, nc, chunk, N)
    Cc = C.reshape(b, nc, chunk, N)

    dA = dtc * A                                          # (b,nc,l,H)
    dA_cs = torch.cumsum(dA, dim=2)                       # inclusive
    # ---- within-chunk (diagonal) term ----
    L = torch.exp(_segsum(dA.transpose(2, 3)))            # (b,nc,H,l,l)
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)           # (b,nc,l,s)
    M = G[:, :, None] * L * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", M, xc)

    # ---- chunk states ----
    decay_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # (b,nc,l,H)
    states = torch.einsum("bcsn,bcshp->bchpn", Bc,
                          (decay_end * dtc)[..., None] * xc)

    # ---- inter-chunk recurrence: the state from before each chunk ----
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])           # (b,nc,H)
    state = (torch.zeros((b, H, Pd, N), dtype=x.dtype, device=x.device)
             if init_state is None else init_state.to(x.dtype))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = states[:, c] + chunk_decay[:, c, :, None, None] * state
    prev_states = torch.stack(prev, dim=1)                # (b,nc,H,P,N)

    # ---- off-diagonal (carried state) term ----
    state_decay = torch.exp(dA_cs)                        # (b,nc,l,H)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, nc * chunk, H, Pd)[:, :S]
    return y, state


def _split_proj(proj, cfg: ModelConfig):
    """[z, x, B, C, dt] along the last axis."""
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di, N, N, H], dim=-1)


def mamba_forward(params, x, cfg: ModelConfig, *, init_state=None,
                  conv_init=None, return_state: bool = False):
    """Full-sequence Mamba-2 block. x: (B, S, d) -> (B, S, d).

    ``init_state``/``conv_init`` continue a previous chunk (chunked
    prefill); with ``return_state`` the updated (SSM state, conv tail) are
    returned too. The conv tail is the last K - 1 rows of the history and
    this chunk's conv inputs, taken before the conv."""
    di, H, N = cfg.d_inner_ssm, cfg.ssm_heads, cfg.ssm_state
    Pd, K = cfg.ssm_head_dim, cfg.ssm_conv
    z, xs, Bm, Cm, dt = _split_proj(x @ params["in_proj"], cfg)
    # causal depthwise conv over (x, B, C)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    hist = (conv_init.to(xbc.dtype) if conv_init is not None else
            torch.zeros((xbc.shape[0], K - 1, xbc.shape[-1]),
                        dtype=xbc.dtype, device=xbc.device))
    conv_tail = torch.cat([hist, xbc], dim=1)[:, -(K - 1):]
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"], history=hist)
    xs, Bm, Cm = F.silu(xbc).split([di, N, N], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(*xs.shape[:2], H, Pd)
    y, state = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                           chunk=cfg.ssm_chunk, init_state=init_state)
    y = y + xh.float() * params["D"][:, None]
    y = y.reshape(*xs.shape[:2], di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, state, conv_tail
    return out


def _causal_conv(x, w, b, history=None):
    """Depthwise causal conv as the sum of K shifted products. x: (B, S,
    C), w: (K, C). ``history``: (B, K - 1, C) inputs preceding x (zeros
    when None)."""
    K, S = w.shape[0], x.shape[1]
    if history is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return out + b


# --------------------------------------------------------------------------
# decode: O(1) recurrent step
# --------------------------------------------------------------------------
def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), **kw),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner_ssm + 2 * cfg.ssm_state), **kw),
    }


def mamba_decode(params, x1, cache: dict, cfg: ModelConfig):
    """One-token step. x1: (B, 1, d). Rolls the conv history and updates
    the state in ``cache``; returns (out (B, 1, d), cache)."""
    di, H, N, Pd = (cfg.d_inner_ssm, cfg.ssm_heads, cfg.ssm_state,
                    cfg.ssm_head_dim)
    z, xs, Bm, Cm, dt = _split_proj((x1 @ params["in_proj"])[:, 0], cfg)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                       # (B, C)
    ht = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    hist = torch.cat([cache["conv"].to(ht), xbc[:, None].to(ht)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist, params["conv_w"].to(ht)) \
        + params["conv_b"]
    cache["conv"] = hist[:, 1:]
    xs, Bm, Cm = F.silu(conv_out).split([di, N, N], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)
    xh = xs.reshape(-1, H, Pd).float()
    st = cache["state"] * dA[..., None, None] \
        + (dt[..., None] * xh)[..., None] * Bm.float()[:, None, None, :]
    cache["state"] = st
    y = torch.einsum("bhpn,bn->bhp", st, Cm.float())
    y = y + xh * params["D"][:, None]
    y = y.reshape(-1, di).to(x1.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return (y @ params["out_proj"])[:, None], cache
