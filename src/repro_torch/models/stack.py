"""Decoder-only model stack for the dense, MoE and pure-SSM families (the
port of ``repro.models.stack``).

Layer parameters are stacked along a leading ``[n_layers]`` axis, as the
reference's are; a Python loop over layers takes each layer's view
(``tree_index``) where the reference runs ``lax.scan``. The decode cache is
a list with one entry per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from . import mamba2 as M2
from . import moe as MOE
from .config import ArchConfig

__all__ = ["init_stack_params", "stack_forward", "init_stack_cache", "DecoderCache",
           "tree_index", "embed_tokens", "lm_logits"]


@dataclasses.dataclass
class DecoderCache:
    attn: Optional[list]    # one L.AttnCache per layer, or None
    ssm: Optional[list]     # one M2.SSMCache per layer, or None


def tree_index(tree, i):
    """The i-th slice of every leaf of a nested dict (a view, no copy)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# per-layer block
# ---------------------------------------------------------------------------

def _init_blocks(gen, cfg: ArchConfig, n: int, device):
    lead = (n,)
    if cfg.family == "ssm":
        return {"norm1": L.init_norm(cfg, lead=lead, device=device),
                "mamba": M2.init_mamba2(gen, cfg, lead=lead, device=device)}
    p = {"norm1": L.init_norm(cfg, lead=lead, device=device),
         "attn": L.init_attention(gen, cfg, lead=lead, device=device)}
    if not cfg.parallel_block:
        p["norm2"] = L.init_norm(cfg, lead=lead, device=device)
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(gen, cfg, lead=lead, device=device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, lead=lead, device=device)
    return p


def _block_apply(p, x, cfg: ArchConfig, *, positions, mode, attn_cache=None,
                 ssm_cache=None):
    """Returns (x, attn_cache', ssm_cache', aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h = L.norm_apply(p["norm1"], x, cfg)
        y, ssm_cache = M2.mamba2_apply(p["mamba"], h, cfg, mode=mode, cache=ssm_cache)
        return x + y, attn_cache, ssm_cache, aux
    h = L.norm_apply(p["norm1"], x, cfg)
    attn_out, attn_cache = L.attn_apply(p["attn"], h, cfg, positions=positions, mode=mode,
                                        cache=attn_cache)
    if cfg.parallel_block:
        # command-r style: attn and MLP read the same normed input
        src, base = h, x + attn_out
    else:
        base = x + attn_out
        src = L.norm_apply(p["norm2"], base, cfg)
    if cfg.is_moe:
        mlp_out, aux_ = MOE.moe_apply(p["moe"], src, cfg)
        aux = aux + aux_
    else:
        mlp_out = L.mlp_apply(p["mlp"], src, cfg)
    return base + mlp_out, attn_cache, ssm_cache, aux


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def init_lm_head(gen, cfg: ArchConfig, device):
    return {"w": torch.randn((cfg.d_model, cfg.vocab), generator=gen, dtype=torch.float32,
                             device=device) / (cfg.d_model ** 0.5)}


def init_stack_params(gen, cfg: ArchConfig, *, device="cpu"):
    p = {
        "embed": L.init_embedding(gen, cfg, device=device),
        "layers": _init_blocks(gen, cfg, cfg.n_layers, device),
        "final_norm": L.init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(gen, cfg, device)
    return p


def init_stack_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, *, device="cpu"):
    n = cfg.n_layers
    if cfg.family == "ssm":
        return DecoderCache(attn=None, ssm=[M2.init_ssm_cache(cfg, batch, dtype, device=device)
                                            for _ in range(n)])
    return DecoderCache(attn=[L.init_attn_cache(cfg, batch, max_seq, dtype,
                                                window=cfg.swa_window, device=device)
                              for _ in range(n)], ssm=None)


def embed_tokens(params, tokens, cfg: ArchConfig):
    return params["embed"]["table"][tokens.long()].to(cfg.activation_dtype)


def lm_logits(params, x, cfg: ArchConfig):
    """Final norm, then the (tied or separate) output projection."""
    x = L.norm_apply(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].to(x.dtype).T
    return x @ params["lm_head"]["w"].to(x.dtype)


def stack_forward(params, tokens, cfg: ArchConfig, *, mode="train",
                  cache: Optional[DecoderCache] = None):
    """tokens [B, T] int; returns (logits [B, T, V], cache', aux)."""
    x = embed_tokens(params, tokens, cfg)
    B, T = x.shape[:2]
    positions = None      # decode takes its position from the cache
    if cfg.family != "ssm" and mode != "decode":
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ac_new, sc_new = [], []
    for i in range(cfg.n_layers):
        aci = cache.attn[i] if cache is not None and cache.attn is not None else None
        sci = cache.ssm[i] if cache is not None and cache.ssm is not None else None
        x, aci, sci, a = _block_apply(tree_index(params["layers"], i), x, cfg,
                                      positions=positions, mode=mode, attn_cache=aci,
                                      ssm_cache=sci)
        aux = aux + a
        ac_new.append(aci)
        sc_new.append(sci)
    logits = lm_logits(params, x, cfg)
    new_cache = None
    if cache is not None:
        new_cache = DecoderCache(attn=ac_new if cache.attn is not None else None,
                                 ssm=sc_new if cache.ssm is not None else None)
    return logits, new_cache, aux
