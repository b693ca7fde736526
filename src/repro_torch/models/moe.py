"""Mixture-of-Experts FFN: top-k router + capacity-based dispatch (the port
of ``repro.models.moe``).

Two execution paths chosen by sequence length:
  * train/prefill — capacity dispatch: tokens are scattered into per-expert
    buffers [B, E, C, d] (per-sequence capacity), expert products run
    batched over E, results gathered back weighted by router probs.
    Overflow tokens drop (standard capacity-factor semantics).
  * decode (T == 1) — dense-all-experts with a mask combine: every expert's
    weights are read anyway at decode, and no cross-batch scatter is needed.
"""
from __future__ import annotations

import functools
import math

import torch

from .layers import act
from .sharding import local_map, mesh_size_of, rows_local, shard_hint

__all__ = ["init_moe", "moe_apply", "top_k_lower_index", "moe_specs"]


def init_moe(gen, cfg, *, lead=(), device="cpu"):
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.moe_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "router": torch.randn(lead + (d, E), generator=gen, **f32) * s_in,
        "wi": torch.randn(lead + (E, d, ff), generator=gen, **f32) * s_in,
        "wo": torch.randn(lead + (E, ff, d), generator=gen, **f32) * s_out,
    }
    if cfg.mlp_glu:
        p["wg"] = torch.randn(lead + (E, d, ff), generator=gen, **f32) * s_in
    return p


def moe_specs(cfg, tp_size: int = 0):
    """Experts on tp when it divides their count (expert parallelism), else
    each expert's hidden dim on tp."""
    ep = "tp" if (tp_size and cfg.moe_experts % tp_size == 0) else None
    inner_tp = None if ep == "tp" else "tp"
    s = {"router": (None, None), "wi": (ep, "fsdp", inner_tp), "wo": (ep, inner_tp, "fsdp")}
    if cfg.mlp_glu:
        s["wg"] = (ep, "fsdp", inner_tp)
    return s


def top_k_lower_index(x, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first, as ``lax.top_k`` orders them (``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn_local(xb, wi, wo, wg, *, cfg):
    """xb [B, E, C, d] batched over experts on the leading E dim of weights."""
    dt = xb.dtype
    h = torch.einsum("becd,edf->becf", xb, wi.to(dt))
    if wg is not None:
        g = torch.einsum("becd,edf->becf", xb, wg.to(dt))
        h = act(h, cfg.act) * g
    else:
        h = act(h, cfg.act)
    return torch.einsum("becf,efd->becd", h, wo.to(dt))


def _expert_ffn(p, xb, cfg):
    """The experts' FFN on the dispatch buffer xb [B, E, C, d]. Over a mesh
    it runs on local blocks (``local_map``): DTensor's own einsum puts E
    over dp in the backward, whose view of that layout fails. The weights
    are gathered over fsdp; with experts on tp each rank runs its experts
    on its rows, with each expert's hidden dim on tp each rank leaves a
    partial sum over tp, and under ``moe_shard_capacity`` each rank runs
    every expert on its share of the capacity."""
    tp_size = mesh_size_of(xb, "tp")
    ep = moe_specs(cfg, tp_size)["wi"][0]
    inner = None if ep or cfg.moe_shard_capacity else "tp"
    if cfg.moe_shard_capacity:
        ep = None
        buf_axes = ("dp", None, "tp", None)
    else:
        buf_axes = ("dp", ep, None, None)
    w_in, w_out = (ep, None, inner), (ep, inner, None)
    return local_map(functools.partial(_expert_ffn_local, cfg=cfg),
                     (xb, p["wi"], p["wo"], p.get("wg")), (buf_axes, w_in, w_out, w_in),
                     buf_axes, partial=inner, site="moe_local")


def moe_apply(p, x, cfg):
    """x [B, T, d] -> (y [B, T, d], aux) with aux = load-balancing loss."""
    B, T, d = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    dt = x.dtype
    # bf16 compute weights promote, as in jnp; over a mesh on each rank's
    # rows (DTensor's own product needs a data-dependent read in the
    # router's weight gradient under fake tensors, the dry run's)
    logits = local_map(_route_logits, (x, p["router"]), (("dp", None, None), (None, None)),
                       ("dp", None, None), site="moe_local")
    probs = torch.softmax(logits, dim=-1)                       # [B, T, E]
    top_p, top_e = top_k_lower_index(probs, K)                  # [B, T, K]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)

    # switch-style load balance: E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))                                 # [E]
    fe = torch.nn.functional.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (me * fe).sum()

    if T == 1:
        # decode: dense-all-experts mask combine
        xb = x[:, None].expand(B, E, T, d)
        ye = _expert_ffn(p, xb, cfg)                            # [B, E, 1, d]
        w = rows_local(functools.partial(_route_weights, E=E), top_e, top_p, site="moe_local")
        y = torch.einsum("bte,betd->btd", w.to(dt), ye)
        return y, aux

    # capacity dispatch per sequence
    C = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    flat_e = top_e.reshape(B, T * K)                            # [B, TK]
    flat_p = top_p.reshape(B, T * K).float()
    onehot = torch.nn.functional.one_hot(flat_e, E)             # [B, TK, E]
    pos = torch.cumsum(onehot, dim=1) - onehot                  # position within expert
    pos = (pos * onehot).sum(dim=-1)                            # [B, TK]
    keep = pos < C
    pos_w = torch.where(keep, pos, C)                           # C -> dropped
    # the scatter and the gather index by computed positions, which DTensor
    # cannot shard: both run on each rank's own rows (the indices are
    # row-local: capacity is per sequence), so the router's outputs and x
    # are gathered over tp first (``rows_local``)
    buf_c = rows_local(functools.partial(_dispatch, E=E, C=C, K=K), x, flat_e, pos_w,
                       site="moe_local")
    if cfg.moe_shard_capacity:
        # EP-over-capacity: the expert compute sharded along tp by the
        # capacity dim (the reference's moe.py hint)
        buf_c = shard_hint(buf_c, "dp", None, "tp", None)
    ye = _expert_ffn(p, buf_c, cfg)                             # [B, E, C, d]
    y = rows_local(functools.partial(_combine, T=T, K=K), ye, flat_e, pos_w, flat_p, keep,
                   site="moe_local")
    return y, aux


def _route_logits(x, router):
    return x.float() @ router.float()


def _route_weights(top_e, top_p, *, E):
    """The decode path's [B, T, E] combine weights: each token's top-k
    probabilities at its experts."""
    B, T, K = top_e.shape
    dev = top_e.device
    w = torch.zeros((B, T, E), dtype=torch.float32, device=dev)
    bidx = torch.arange(B, device=dev)[:, None, None].expand(B, T, K)
    tidx = torch.arange(T, device=dev)[None, :, None].expand(B, T, K)
    w.index_put_((bidx, tidx, top_e), top_p, accumulate=True)
    return w


def _token_index(B, T, K, dev):
    """(row, token) of each of the B x T*K assignments."""
    tok = torch.arange(T, device=dev)[None, :, None].expand(B, T, K).reshape(B, T * K)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T * K)
    return bidx, tok


def _dispatch(x, flat_e, pos_w, *, E, C, K):
    """Scatter each kept assignment's token into its expert's buffer: the
    [B, E, C, d] view of a [B, E, C + 1, d] buffer whose slot C collects
    the dropped ones."""
    B, T, d = x.shape
    bidx, tok = _token_index(B, T, K, x.device)
    buf = torch.zeros((B, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, flat_e, pos_w), x[bidx, tok], accumulate=True)
    return buf[:, :, :C]


def _combine(ye, flat_e, pos_w, flat_p, keep, *, T, K):
    """Gather each assignment's expert output back to its token, weighted by
    its router probability (dropped ones read the zero slot C)."""
    B, E, C, d = ye.shape
    dt, dev = ye.dtype, ye.device
    bidx, tok = _token_index(B, T, K, dev)
    ye = torch.cat([ye, torch.zeros((B, E, 1, d), dtype=dt, device=dev)], dim=2)
    gathered = ye[bidx, flat_e, pos_w]                          # [B, TK, d]
    weighted = gathered * (flat_p * keep.float())[..., None].to(dt)
    y = torch.zeros((B, T, d), dtype=dt, device=dev)
    y.index_put_((bidx, tok), weighted, accumulate=True)
    return y
