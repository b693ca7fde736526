"""Shared neural layers: norms, embeddings, RoPE, attention (chunked flash
train/prefill + cached decode), MLP (the port of ``repro.models.layers``).

Parameters are nested dicts of tensors with the reference's names and
layouts (``wq`` is ``[d, H, hd]``, ``wo`` is ``[H, hd, d]``), so carrying
weights across is a copy. Every ``init_*`` takes a ``lead`` shape that
prefixes each leaf: the stack's ``[n_layers]`` axis, drawn in one call.

Numerics follow the reference: fp32 master weights cast to the activation
dtype at every use; norms, RoPE and softmax in fp32; attention scores and
P·V accumulated in fp32 (the reference's ``preferred_element_type``: the
operands are upcast, since a bf16 ``torch.matmul`` rounds its output).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .sharding import local_map, mesh_size_of, reduced

__all__ = [
    "init_norm", "norm_apply", "init_embedding", "rope", "sincos_positions",
    "init_attention", "flash_attention", "decode_attention", "attention",
    "cached_attention", "AttnCache",
    "init_attn_cache", "cache_update", "cache_valid_mask", "attn_apply",
    "init_mlp", "mlp_apply", "act", "norm_specs", "embedding_specs", "attention_specs",
    "mlp_specs", "stacked_specs",
]


def _normal(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg, *, lead=(), device="cpu"):
    d = cfg.d_model
    p = {"scale": torch.ones(lead + (d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=torch.float32, device=device)
    return p


def norm_apply(p, x, cfg):
    eps = cfg.norm_eps
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / positions
# ---------------------------------------------------------------------------

# Sharding specs: trees of logical axis names, one tuple a tensor dim
# ("dp", "fsdp", "tp", "sp" or None), resolved against a mesh by
# ``models.sharding.AxisRules``; the reference's trees name for name.

def norm_specs(cfg):
    s = {"scale": (None,)}
    if cfg.norm == "layernorm":
        s["bias"] = (None,)
    return s


def embedding_specs(cfg):
    return {"table": ("tp", "fsdp")}


def attention_specs(cfg, tp_size: int = 0):
    """Weight specs. Head dims shard on tp when divisible, else the head
    width takes tp (contraction-sharded); fsdp always on the other dim."""
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q_head_ax = "tp" if (tp_size == 0 or H % max(tp_size, 1) == 0) else None
    kv_head_ax = "tp" if (tp_size and KV % tp_size == 0) else None
    hd_ax = "tp" if q_head_ax is None and tp_size and hd % tp_size == 0 else None
    kv_hd_ax = hd_ax if kv_head_ax is None else None
    s = {"wq": ("fsdp", q_head_ax, hd_ax), "wk": ("fsdp", kv_head_ax, kv_hd_ax),
         "wv": ("fsdp", kv_head_ax, kv_hd_ax), "wo": (q_head_ax, hd_ax, "fsdp")}
    if cfg.use_qk_norm:
        s["q_norm"] = (None,)
        s["k_norm"] = (None,)
    if cfg.attn_bias:
        s["bq"] = (q_head_ax, hd_ax)
        s["bk"] = (kv_head_ax, None)
        s["bv"] = (kv_head_ax, None)
        s["bo"] = (None,)
    return s


def mlp_specs(cfg):
    s = {"wi": ("fsdp", "tp"), "wo": ("tp", "fsdp")}
    if cfg.mlp_glu:
        s["wg"] = ("fsdp", "tp")
    return s


def stacked_specs(tree, n: int = 1):
    """The specs of ``tree``'s leaves stacked under ``n`` leading layer axes
    (never sharded)."""
    if isinstance(tree, dict):
        return {k: stacked_specs(v, n) for k, v in tree.items()}
    return (None,) * n + tree


def init_embedding(gen, cfg, *, device="cpu"):
    return {"table": _normal(gen, (cfg.vocab, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
                             device)}


def sincos_positions(positions, d, dtype=torch.float32):
    """Sinusoidal position embeddings [..., d] for arbitrary positions."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def rope(x, positions, theta):
    """Rotary embedding, half-split form, in fp32. x [..., T, H, hd],
    positions [..., T]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq                      # [..., T, half]
    cos = torch.cos(ang)[..., None, :]                             # [..., T, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, *, lead=(), device="cpu"):
    d = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(H * hd)
    p = {
        "wq": _normal(gen, lead + (d, H, hd), s_in, device),
        "wk": _normal(gen, lead + (d, KV, hd), s_in, device),
        "wv": _normal(gen, lead + (d, KV, hd), s_in, device),
        "wo": _normal(gen, lead + (H, hd, d), s_out, device),
    }
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), **f32)
        p["k_norm"] = torch.ones(lead + (hd,), **f32)
    if cfg.attn_bias:
        p["bq"] = torch.zeros(lead + (H, hd), **f32)
        p["bk"] = torch.zeros(lead + (KV, hd), **f32)
        p["bv"] = torch.zeros(lead + (KV, hd), **f32)
        p["bo"] = torch.zeros(lead + (d,), **f32)
    return p


def _qk_norm(x, scale, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _heads_in(x, w):
    return torch.einsum("btd,dhk->bthk", x, w)


def _heads_out(o, w):
    return torch.einsum("bthk,hkd->btd", o, w)


# Over a mesh the projections run on local blocks (``local_map``), rows
# over dp and heads over tp, each weight gathered over fsdp: each rank
# computes its own heads (Megatron's column- and row-parallel products). Left
# to DTensor's own einsum, torch 2.11-2.13 shards the flattened (heads x
# head_dim) output over tp where tp does not divide H and then cannot
# unflatten it ("Cannot unflatten unevenly sharded tensor"), and its
# backward computes each weight's whole gradient on every tp rank. Where tp
# does not divide H the heads' axis is dropped: the weight is gathered whole
# and every tp rank computes all H heads of its rows.

def _project(x, w):
    """x [B, T, d] @ w [d, H, hd] -> [B, T, H, hd] in x's dtype (the
    attention projections of every family)."""
    w = w.to(x.dtype)
    if mesh_size_of(w, "tp"):
        return local_map(_heads_in, (x, w), (("dp", None, None), (None, "tp", None)),
                         ("dp", None, "tp", None), site="head_projection")
    return _heads_in(x, w)


def _unproject(o, w):
    """o [B, T, H, hd] @ w [H, hd, d] -> [B, T, d] in o's dtype (the output
    projection); over a mesh on local blocks as ``_project``, its heads'
    partial sums over tp summed at once (``reduced``)."""
    w = w.to(o.dtype)
    if mesh_size_of(w, "tp"):
        return reduced(local_map(_heads_out, (o, w), (("dp", None, "tp", None),
                                                      ("tp", None, None)),
                                 ("dp", None, None), partial="tp", site="head_projection"))
    return _heads_out(o, w)


def _project_q(p, x, cfg):
    q = _project(x, p["wq"])
    if cfg.attn_bias:
        q = q + p["bq"].to(x.dtype)
    if cfg.use_qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _kv_spread(p, cfg, x):
    """The K and V weights (and biases), each KV head repeated tp / KV times
    over a mesh whose tp the KV heads do not divide but the query heads do
    (and KV divides tp): tp heads, one a tp rank, which the local
    projection computes once each instead of every rank all KV heads.
    Query head h reads spread head h // (H / tp), a copy of KV head
    h // (H / KV), as in one process. Without a mesh: the weights."""
    tp, KV = mesh_size_of(x, "tp"), cfg.n_kv
    names = ("wk", "wv") + (("bk", "bv") if cfg.attn_bias else ())
    if not tp or KV % tp == 0 or tp % KV or cfg.n_heads % tp:
        return {n: p[n] for n in names}
    # spread head j' = KV head j' // (tp / KV), by a 0/1 product: its
    # backward sums the copies' gradients by a product too (the backward of
    # repeat_interleave views the tp heads as (KV, tp / KV), which DTensor
    # cannot do to a dim sharded over tp)
    spread = (torch.arange(KV)[:, None] == torch.arange(tp)[None, :] // (tp // KV))
    return {n: torch.einsum("...kh,kt->...th", p[n], spread.to(p[n].dtype).to(p[n].device))
            for n in names}


def _project_qkv(p, x, cfg, positions, *, spread=False):
    """``spread`` (a forward that writes no cache): K and V at tp heads over a
    mesh (``_kv_spread``)."""
    dt = x.dtype
    kv = _kv_spread(p, cfg, x) if spread else p
    q, k, v = _project(x, p["wq"]), _project(x, kv["wk"]), _project(x, kv["wv"])
    if cfg.attn_bias:
        q = q + p["bq"].to(dt)
        k = k + kv["bk"].to(dt)
        v = v + kv["bv"].to(dt)
    if cfg.use_qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:  # rope (None for whisper-style abs positions)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q, k, v, *, causal=True, window=0, chunk_q=512, chunk_k=512):
    """Chunked (flash-style) attention with O(T * chunk_k) live memory.

    q [B, Tq, H, hd]; k, v [B, Tk, KV, hd] (GQA: KV divides H; query head h
    reads KV head h // G). ``window`` > 0 masks keys older than ``window``
    (sliding-window attention); key chunks outside the causal and window band
    are skipped. The reference's guards are kept: a row whose keys in a chunk
    are all masked adds nothing from that chunk, and a row with no valid key
    comes out 0.
    """
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    chunk_q = min(chunk_q, Tq)
    chunk_k = min(chunk_k, Tk)
    nq = -(-Tq // chunk_q)
    nk_total = -(-Tk // chunk_k)
    pad_k = nk_total * chunk_k - Tk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    pad_q = nq * chunk_q - Tq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    dev = q.device
    outs = []
    for qi in range(nq):
        q_start = qi * chunk_q
        qc = q[:, q_start:q_start + chunk_q].float()
        qpos = q_start + torch.arange(chunk_q, device=dev)
        hi = min((q_start + chunk_q + chunk_k - 1) // chunk_k, nk_total) if causal else nk_total
        lo = max((q_start - window) // chunk_k, 0) if window > 0 else 0
        m = torch.full((B, H, chunk_q), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, chunk_q, hd), dtype=torch.float32, device=dev)
        for ki in range(lo, hi):
            k_start = ki * chunk_k
            kc = k[:, k_start:k_start + chunk_k].repeat_interleave(G, dim=2)  # [B, ck, H, hd]
            vc = v[:, k_start:k_start + chunk_k].repeat_interleave(G, dim=2)
            s = torch.einsum("bqhk,bshk->bhqs", qc, kc.float()) * scale
            kpos = k_start + torch.arange(chunk_k, device=dev)
            mask = torch.ones((chunk_q, chunk_k), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window > 0:
                mask &= qpos[:, None] - kpos[None, :] < window
            mask &= (kpos < Tk)[None, :]
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            pr = torch.exp(s - m_safe[..., None])
            pr = torch.where(mask, pr, 0.0)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + pr.sum(dim=-1)
            # P is rounded to V's dtype, as the reference's einsum operand is
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshk->bhqk", pr.to(vc.dtype).float(), vc.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-20)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Tq]


def decode_attention(q, k_cache, v_cache, valid_mask):
    """Single-token decode against a KV cache.

    q [B, 1, H, hd]; caches [B, S, KV, hd]; valid_mask [B, S] bool. Query
    head h reads KV head h // G (``q.reshape(B, KV, G, hd)``)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    q5 = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", q5, k_cache.float()) / math.sqrt(hd)
    valid = valid_mask[:, None, None, :]
    s = torch.where(valid, s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m)
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(), v_cache.float())
    out = out / torch.clamp_min(l, 1e-20)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _heads_local(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` on each rank's batch rows and heads: over a
    mesh the attention core runs on local blocks (``local_map``), batch over
    dp and heads over tp, the KV heads repeated to the query heads first
    where they do not divide over tp (query head h reads KV head h // G in
    either layout). DTensor's view of the products' flattened (batch, head)
    dims fails in torch 2.11, and the chunk loop's small ops would each pay
    DTensor's dispatch. ``rest`` are [B, S] masks."""
    tp = mesh_size_of(q, "tp")
    if tp and k.shape[2] % tp:
        G = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    heads = ("dp", None, "tp", None)
    return local_map(fn, (q, k, v, *rest), (heads, heads, heads) + (("dp", None),) * len(rest),
                     heads, site="attention_core")


def attention(q, k, v, *, causal=True, window=0):
    """``flash_attention`` over a mesh's local heads (``_heads_local``)."""
    return _heads_local(functools.partial(flash_attention, causal=causal, window=window),
                        q, k, v)


def cached_attention(q, k_cache, v_cache, valid_mask):
    """``decode_attention`` over a mesh's local heads (``_heads_local``)."""
    return _heads_local(decode_attention, q, k_cache, v_cache, valid_mask)


@dataclasses.dataclass
class AttnCache:
    """KV cache for one attention site. ``length`` (tokens written so far,
    the next absolute position) is a host int, so a decode step needs no
    device read to place its token. ``cache_update`` writes the new slot
    into ``k``/``v`` in place and returns the cache one token longer."""

    k: torch.Tensor       # [B, S, KV, hd]
    v: torch.Tensor
    length: int = 0
    window: int = 0       # >0: ring buffer of this many slots


def init_attn_cache(cfg, batch, seq, dtype, window=0, *, device="cpu"):
    KV, hd = cfg.n_kv, cfg.hd
    slots = min(seq, window) if window > 0 else seq
    return AttnCache(
        k=torch.zeros((batch, slots, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, slots, KV, hd), dtype=dtype, device=device),
        length=0,
        window=window if window and window < seq else 0,
    )


def _roll_slots(x, shift: int):
    """``torch.roll(x, shift, dims=1)`` as two slices (DTensor in torch 2.11
    has no sharding strategy for ``aten.roll``)."""
    return torch.cat([x[:, x.shape[1] - shift:], x[:, :x.shape[1] - shift]], dim=1) \
        if shift else x


def _by_sequence(buf) -> bool:
    """A DTensor cache whose slots lie over a mesh dim ("sp": its KV heads do
    not divide tp)."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(buf, DTensor) and any(isinstance(p, Shard) and p.dim == 1
                                            for p in buf.placements)


def _write_slot(buf, slot: int, new):
    """buf[:, slot] = new[:, 0] in place. On a cache whose slots lie over a
    mesh dim, a slice write would put the token at that index of every
    rank's local block: the slot is picked by a mask over all S slots
    instead (each rank rewrites its block)."""
    if _by_sequence(buf):
        hit = torch.arange(buf.shape[1], device=buf.device) == slot
        buf.copy_(torch.where(hit[None, :, None, None], new.to(buf.dtype), buf))
    else:
        buf[:, slot] = new[:, 0].to(buf.dtype)


def cache_update(cache: AttnCache, k_new, v_new) -> AttnCache:
    """Append k/v [B, 1, KV, hd]; ring-buffer write for SWA caches, else the
    slot clamps to S - 1."""
    pos = cache.length
    S = cache.k.shape[1]
    slot = pos % S if cache.window else min(pos, S - 1)
    _write_slot(cache.k, slot, k_new)
    _write_slot(cache.v, slot, v_new)
    return AttnCache(k=cache.k, v=cache.v, length=pos + 1, window=cache.window)


def cache_valid_mask(cache: AttnCache):
    """Slots a decode step may read, taken on the cache BEFORE its update:
    slot ``length`` is the one the step writes."""
    S = cache.k.shape[1]
    idx = torch.arange(S, device=cache.k.device)
    if cache.window:
        valid = idx < min(cache.length + 1, S)
    else:
        valid = idx <= cache.length
    return valid[None, :].expand(cache.k.shape[0], S)


def attn_apply(p, x, cfg, *, positions=None, mode="train", use_rope=True,
               cache: Optional[AttnCache] = None, kv_override=None):
    """Full attention block body (projection -> attention -> output).

    mode: "train"/"prefill" (chunked flash) | "decode" (cached single token)
    use_rope: rotary positions (decode derives the position from the cache)
    kv_override: (k, v, mask) for cross-attention (whisper decoder).
    """
    dt = x.dtype
    if mode == "decode":
        B = x.shape[0]
        if kv_override is not None:
            q = _project_q(p, x, cfg)
            k, v, mask = kv_override
            out = cached_attention(q, k, v, mask)
            new_cache = cache
        else:
            pos = torch.full((B, 1), cache.length, dtype=torch.int32, device=x.device)
            q, k, v = _project_qkv(p, x, cfg, pos if use_rope else None)
            valid = cache_valid_mask(cache)
            new_cache = cache_update(cache, k, v)
            out = cached_attention(q, new_cache.k, new_cache.v, valid)
        y = _unproject(out, p["wo"])
        if cfg.attn_bias:
            y = y + p["bo"].to(dt)
        return y, new_cache

    # train / prefill
    if kv_override is not None:
        q = _project_q(p, x, cfg)
        k, v, _ = kv_override
        out = attention(q, k, v, causal=False)
    else:
        q, k, v = _project_qkv(p, x, cfg, positions if use_rope else None,
                               spread=cache is None)
        out = attention(q, k, v, causal=True, window=cfg.swa_window)
    y = _unproject(out, p["wo"])
    if cfg.attn_bias:
        y = y + p["bo"].to(dt)
    if mode == "prefill" and cache is not None and kv_override is None:
        slots = cache.k.shape[1]
        T = k.shape[1]
        if cache.window and T > slots:
            # ring layout: slot = pos % window (rolled[p % W] = token at p)
            roll = (T - slots) % slots
            k_w = _roll_slots(k[:, -slots:], roll)
            v_w = _roll_slots(v[:, -slots:], roll)
            cache.k.copy_(k_w)
            cache.v.copy_(v_w)
        elif _by_sequence(cache.k):
            # the prompt's slots, the rest zero, as one copy (a slice write
            # would land at the same local index of every rank's block)
            cache.k.copy_(F.pad(k.to(cache.k.dtype), (0, 0, 0, 0, 0, slots - T)))
            cache.v.copy_(F.pad(v.to(cache.v.dtype), (0, 0, 0, 0, 0, slots - T)))
        else:
            cache.k.zero_()
            cache.v.zero_()
            cache.k[:, :T] = k.to(cache.k.dtype)
            cache.v[:, :T] = v.to(cache.v.dtype)
        return y, AttnCache(k=cache.k, v=cache.v, length=T, window=cache.window)
    return y, cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg, *, lead=(), device="cpu"):
    d, ff = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {"wi": _normal(gen, lead + (d, ff), s_in, device),
         "wo": _normal(gen, lead + (ff, d), s_out, device)}
    if cfg.mlp_glu:
        p["wg"] = _normal(gen, lead + (d, ff), s_in, device)
    return p


def act(x, kind):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default; torch's
    default is the erf form)."""
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def _mlp(x, wi, wg, wo, *, kind):
    h = x @ wi
    h = act(h, kind) * (x @ wg) if wg is not None else act(h, kind)
    return h @ wo


def mlp_apply(p, x, cfg):
    """Over a mesh on local blocks (as the attention projections): rows over
    dp, the hidden dim over tp, the weights gathered over fsdp; the output's
    partial sums over tp are summed at once (``reduced``)."""
    dt = x.dtype
    w = [p["wi"].to(dt), p["wg"].to(dt) if cfg.mlp_glu else None, p["wo"].to(dt)]
    fn = functools.partial(_mlp, kind=cfg.act)
    if mesh_size_of(w[0], "tp"):
        col = (None, "tp")
        return reduced(local_map(fn, (x, *w), (("dp", None, None), col, col, ("tp", None)),
                                 ("dp", None, None), partial="tp", site="mlp_block"))
    return fn(x, *w)
