"""Zamba2-style hybrid: Mamba2 backbone + one *shared* (weight-tied)
attention+MLP block applied every ``shared_attn_every`` backbone layers (the
port of ``repro.models.hybrid``).

Structure (54 layers, shared_every=6 -> 9 groups):
    [6 x mamba2] -> shared_block -> [6 x mamba2] -> shared_block -> ...
The shared block has a single weight copy but a *per-site* KV cache (one per
group). The published model's per-site LoRAs are omitted, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from . import mamba2 as M2
from .config import ArchConfig
from .stack import attn_cache_spec, embed_tokens, init_lm_head, lm_logits, remat, unstack

__all__ = ["init_hybrid_params", "hybrid_forward", "init_hybrid_cache", "HybridCache",
           "hybrid_param_specs", "hybrid_cache_specs"]


@dataclasses.dataclass
class HybridCache:
    ssm: list                     # [n_groups][group_size] M2.SSMCache
    attn: Optional[list]          # [n_groups] L.AttnCache


def _groups(cfg: ArchConfig):
    g = cfg.shared_attn_every
    if cfg.n_layers % g:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"shared_attn_every {g}")
    return cfg.n_layers // g, g


def init_hybrid_params(gen, cfg: ArchConfig, *, device="cpu"):
    ng, gs = _groups(cfg)
    lead = (ng, gs)
    p = {
        "embed": L.init_embedding(gen, cfg, device=device),
        "mamba": {"norm": L.init_norm(cfg, lead=lead, device=device),
                  "mamba": M2.init_mamba2(gen, cfg, lead=lead, device=device)},
        "shared": {
            "norm1": L.init_norm(cfg, device=device),
            "attn": L.init_attention(gen, cfg, device=device),
            "norm2": L.init_norm(cfg, device=device),
            "mlp": L.init_mlp(gen, cfg, device=device),
        },
        "final_norm": L.init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(gen, cfg, device)
    return p


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, *, device="cpu"):
    ng, gs = _groups(cfg)
    return HybridCache(
        ssm=[[M2.init_ssm_cache(cfg, batch, dtype, device=device) for _ in range(gs)]
             for _ in range(ng)],
        attn=[L.init_attn_cache(cfg, batch, max_seq, dtype, window=cfg.swa_window,
                                device=device) for _ in range(ng)])


def hybrid_param_specs(cfg: ArchConfig, tp_size: int = 0):
    """Logical axes of ``init_hybrid_params``'s tree (mamba layers stacked
    [n_groups, group_size])."""
    s = {
        "embed": L.embedding_specs(cfg),
        "mamba": L.stacked_specs({"norm": L.norm_specs(cfg),
                                  "mamba": M2.mamba2_specs(cfg, tp_size)}, 2),
        "shared": {"norm1": L.norm_specs(cfg), "attn": L.attention_specs(cfg, tp_size),
                   "norm2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)},
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = {"w": ("fsdp", "tp")}
    return s


def hybrid_cache_specs(cfg: ArchConfig, tp_size: int = 0, seq_len: int = 0):
    """Logical axes of ``init_hybrid_cache``'s tree: [group][layer] SSM
    caches and one attention cache a group, each the reference's stacked
    spec without its leading axes."""
    ng, gs = _groups(cfg)
    return HybridCache(
        ssm=[[M2.SSMCache(state=("dp", "tp", None, None), conv=("dp", None, "tp"), length=())
              for _ in range(gs)] for _ in range(ng)],
        attn=[attn_cache_spec(cfg, tp_size, seq_len, window=cfg.swa_window)
              for _ in range(ng)])


def _shared_block(p, x, cfg, *, positions, mode, cache):
    h = L.norm_apply(p["norm1"], x, cfg)
    attn_out, cache = L.attn_apply(p["attn"], h, cfg, positions=positions, mode=mode,
                                   cache=cache)
    h2 = x + attn_out
    g = L.norm_apply(p["norm2"], h2, cfg)
    return h2 + L.mlp_apply(p["mlp"], g, cfg), cache


def hybrid_forward(params, tokens, cfg: ArchConfig, *, mode="train",
                   cache: Optional[HybridCache] = None):
    x = embed_tokens(params, tokens, cfg)
    B, T = x.shape[:2]
    positions = None      # decode takes its position from the cache
    if mode != "decode":
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)

    def group(gp, shared, x, group_sc, ac):
        """One group: its backbone layers, then the shared block."""
        sc_out = []
        for i, lp in enumerate(unstack(gp)):
            h = L.norm_apply(lp["norm"], x, cfg)
            y, sc = M2.mamba2_apply(lp["mamba"], h, cfg, mode=mode,
                                    cache=group_sc[i] if group_sc is not None else None)
            x = x + y
            sc_out.append(sc)
        x, ac = _shared_block(shared, x, cfg, positions=positions, mode=mode, cache=ac)
        return x, sc_out, ac

    # the reference checkpoints a whole group (hybrid.py's group_body)
    group = remat(group, cfg, mode)
    sc_new, ac_new = [], []
    for g, gp in enumerate(unstack(params["mamba"])):
        x, group_sc, ac = group(gp, params["shared"], x,
                                cache.ssm[g] if cache is not None else None,
                                cache.attn[g] if cache is not None else None)
        sc_new.append(group_sc)
        ac_new.append(ac)
    logits = lm_logits(params, x, cfg)
    new_cache = HybridCache(ssm=sc_new, attn=ac_new) if cache is not None else None
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)
