"""Whisper-style encoder-decoder backbone, frontend stubbed (the port of
``repro.models.encdec``).

The conv/mel frontend is a stub: callers pass precomputed frame embeddings
[B, T_frames, d]. The encoder is a bidirectional transformer over frames
with sinusoidal positions; the decoder is causal self-attention +
cross-attention to the encoded frames, also with sinusoidal positions (no
RoPE, as in Whisper). Cross K/V are computed once per layer at prefill and
carried in the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from .config import ArchConfig
from .sharding import shard_hint
from .stack import attn_cache_spec, embed_tokens, remat, unstack

__all__ = ["init_encdec_params", "encode", "decode_forward", "init_encdec_cache",
           "EncDecCache", "encdec_param_specs", "encdec_cache_specs"]


@dataclasses.dataclass
class EncDecCache:
    self_attn: list                   # [n_layers] L.AttnCache
    cross_k: list                     # [n_layers] [B, T_enc, KV, hd]
    cross_v: list


def _init_layers(gen, cfg, n, names, device):
    lead = (n,)
    p = {}
    for name in names:
        if name.startswith("norm"):
            p[name] = L.init_norm(cfg, lead=lead, device=device)
        elif name.endswith("attn"):
            p[name] = L.init_attention(gen, cfg, lead=lead, device=device)
        else:
            p[name] = L.init_mlp(gen, cfg, lead=lead, device=device)
    return p


def init_encdec_params(gen, cfg: ArchConfig, *, device="cpu"):
    return {
        "embed": L.init_embedding(gen, cfg, device=device),
        "enc_layers": _init_layers(gen, cfg, cfg.enc_layers,
                                   ("norm1", "attn", "norm2", "mlp"), device),
        "enc_norm": L.init_norm(cfg, device=device),
        "dec_layers": _init_layers(gen, cfg, cfg.n_layers,
                                   ("norm1", "self_attn", "norm_x", "cross_attn", "norm2",
                                    "mlp"), device),
        "final_norm": L.init_norm(cfg, device=device),
    }


def encdec_param_specs(cfg: ArchConfig, tp_size: int = 0):
    """Logical axes of ``init_encdec_params``'s tree (layers stacked)."""
    attn = L.attention_specs(cfg, tp_size)
    enc = {"norm1": L.norm_specs(cfg), "attn": attn, "norm2": L.norm_specs(cfg),
           "mlp": L.mlp_specs(cfg)}
    dec = {"norm1": L.norm_specs(cfg), "self_attn": attn, "norm_x": L.norm_specs(cfg),
           "cross_attn": attn, "norm2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    return {"embed": L.embedding_specs(cfg), "enc_layers": L.stacked_specs(enc),
            "enc_norm": L.norm_specs(cfg), "dec_layers": L.stacked_specs(dec),
            "final_norm": L.norm_specs(cfg)}


def encdec_cache_specs(cfg: ArchConfig, tp_size: int = 0, seq_len: int = 0):
    """Logical axes of ``init_encdec_cache``'s tree, one spec a layer (the
    self-attention cache has no window)."""
    n = cfg.n_layers
    kv_ax = "tp" if (tp_size and cfg.n_kv % tp_size == 0) else None
    cross = ("dp", None, kv_ax, None)
    return EncDecCache(self_attn=[attn_cache_spec(cfg, tp_size, seq_len, window=0)
                                  for _ in range(n)],
                       cross_k=[cross] * n, cross_v=[cross] * n)


def encode(params, frames, cfg: ArchConfig):
    """frames [B, T_enc, d] (stub frontend output) -> [B, T_enc, d]."""
    dt = cfg.activation_dtype
    T = frames.shape[1]
    pos = L.sincos_positions(torch.arange(T, device=frames.device), cfg.d_model, dtype=dt)
    x = frames.to(dt) + pos[None]
    # as the reference, checkpointed whenever cfg.remat asks (encode has no
    # mode); remat() skips it when no graph is recorded
    layer = remat(_encoder_layer, cfg, "train")
    for lp in unstack(params["enc_layers"]):
        x = layer(lp, x, cfg)
    return L.norm_apply(params["enc_norm"], x, cfg)


def _encoder_layer(lp, x, cfg: ArchConfig):
    dt = x.dtype
    h = L.norm_apply(lp["norm1"], x, cfg)
    q, k, v = (L._project(h, lp["attn"][w]) for w in ("wq", "wk", "wv"))
    if cfg.attn_bias:
        q = q + lp["attn"]["bq"].to(dt)
        k = k + lp["attn"]["bk"].to(dt)
        v = v + lp["attn"]["bv"].to(dt)
    out = L.attention(q, k, v, causal=False)
    y = L._unproject(out, lp["attn"]["wo"])
    if cfg.attn_bias:
        y = y + lp["attn"]["bo"].to(dt)
    x = x + y
    g = L.norm_apply(lp["norm2"], x, cfg)
    return x + L.mlp_apply(lp["mlp"], g, cfg)


def _cross_kv(lp, enc_out, cfg):
    dt = enc_out.dtype
    k = L._project(enc_out, lp["cross_attn"]["wk"])
    v = L._project(enc_out, lp["cross_attn"]["wv"])
    if cfg.attn_bias:
        k = k + lp["cross_attn"]["bk"].to(dt)
        v = v + lp["cross_attn"]["bv"].to(dt)
    return k, v


def init_encdec_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, *, device="cpu"):
    n = cfg.n_layers
    shape = (batch, cfg.enc_frames, cfg.n_kv, cfg.hd)
    return EncDecCache(
        self_attn=[L.init_attn_cache(cfg, batch, max_seq, dtype, window=0, device=device)
                   for _ in range(n)],
        cross_k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)],
        cross_v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)],
    )


def decode_forward(params, tokens, enc_out, cfg: ArchConfig, *, mode="train",
                   cache: Optional[EncDecCache] = None):
    """Decoder pass. enc_out may be None when ``cache`` carries cross K/V.

    Returns (logits, cache', aux)."""
    dt = cfg.activation_dtype
    x = embed_tokens(params, tokens, cfg)
    B, T = x.shape[:2]
    dev = x.device
    if mode == "decode":
        pos_idx = torch.tensor([[cache.self_attn[0].length]], device=dev)
        x = x + L.sincos_positions(pos_idx, cfg.d_model, dtype=dt)
    else:
        x = x + L.sincos_positions(torch.arange(T, device=dev), cfg.d_model, dtype=dt)[None]
    precomp = cache is not None and enc_out is None

    def layer(lp, x, ac, kv):
        h = L.norm_apply(lp["norm1"], x, cfg)
        y, ac = L.attn_apply(lp["self_attn"], h, cfg, mode=mode, use_rope=False, cache=ac)
        x = x + y
        # cross attention
        hx = L.norm_apply(lp["norm_x"], x, cfg)
        k, v = kv if kv is not None else _cross_kv(lp, enc_out, cfg)
        mask = torch.ones((B, k.shape[1]), dtype=torch.bool, device=dev)
        y, _ = L.attn_apply(lp["cross_attn"], hx, cfg, mode=mode, use_rope=False,
                            kv_override=(k, v, mask))
        x = x + y
        g = L.norm_apply(lp["norm2"], x, cfg)
        return x + L.mlp_apply(lp["mlp"], g, cfg), ac, k, v

    layer = remat(layer, cfg, mode)
    ac_new, ck_new, cv_new = [], [], []
    for i, lp in enumerate(unstack(params["dec_layers"])):
        x, ac, k, v = layer(lp, x, cache.self_attn[i] if cache is not None else None,
                            (cache.cross_k[i], cache.cross_v[i]) if precomp else None)
        if cache is not None:
            ac_new.append(ac)
            ck_new.append(k.to(dt))
            cv_new.append(v.to(dt))
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = shard_hint(x @ params["embed"]["table"].to(x.dtype).T, "dp", None, "tp")
    new_cache = None
    if cache is not None:
        new_cache = EncDecCache(self_attn=ac_new, cross_k=ck_new, cross_v=cv_new)
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=dev)
