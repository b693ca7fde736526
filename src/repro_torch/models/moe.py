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

import math

import torch

from .layers import act

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


def _expert_ffn(p, xb, cfg):
    """xb [B, E, C, d] batched over experts on the leading E dim of weights."""
    dt = xb.dtype
    h = torch.einsum("becd,edf->becf", xb, p["wi"].to(dt))
    if cfg.mlp_glu:
        g = torch.einsum("becd,edf->becf", xb, p["wg"].to(dt))
        h = act(h, cfg.act) * g
    else:
        h = act(h, cfg.act)
    return torch.einsum("becf,efd->becd", h, p["wo"].to(dt))


def moe_apply(p, x, cfg):
    """x [B, T, d] -> (y [B, T, d], aux) with aux = load-balancing loss."""
    B, T, d = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    dt = x.dtype
    dev = x.device
    logits = x.float() @ p["router"]
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
        w = torch.zeros((B, T, E), dtype=torch.float32, device=dev)
        bidx = torch.arange(B, device=dev)[:, None, None].expand(B, T, K)
        tidx = torch.arange(T, device=dev)[None, :, None].expand(B, T, K)
        w.index_put_((bidx, tidx, top_e), top_p, accumulate=True)
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
    tok = torch.arange(T, device=dev)[None, :, None].expand(B, T, K).reshape(B, T * K)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T * K)

    buf = torch.zeros((B, E, C + 1, d), dtype=dt, device=dev)
    buf.index_put_((bidx, flat_e, pos_w), x[bidx, tok], accumulate=True)
    ye = _expert_ffn(p, buf[:, :, :C], cfg)                     # [B, E, C, d]
    ye = torch.cat([ye, torch.zeros((B, E, 1, d), dtype=ye.dtype, device=dev)], dim=2)
    gathered = ye[bidx, flat_e, pos_w]                          # [B, TK, d]
    weighted = gathered * (flat_p * keep.float())[..., None].to(dt)
    y = torch.zeros((B, T, d), dtype=dt, device=dev)
    y.index_put_((bidx, tok), weighted, accumulate=True)
    return y, aux
