"""Decoder-only model stack for the dense, MoE and pure-SSM families (the
port of ``repro.models.stack``).

Layer parameters are stacked along a leading ``[n_layers]`` axis, as the
reference's are; a Python loop over layers takes each layer's view
(``unstack``) where the reference runs ``lax.scan``, and ``remat`` wraps
the loop body in activation checkpointing as the reference's
``_maybe_remat`` wraps the scanned body. The decode cache is a list with
one entry per layer.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from . import layers as L
from . import mamba2 as M2
from . import moe as MOE
from .config import ArchConfig
from .sharding import replicated, shard_hint

__all__ = ["init_stack_params", "stack_forward", "init_stack_cache", "DecoderCache",
           "unstack", "remat", "embed_tokens", "lm_logits", "compute_weights", "stack_param_specs",
           "stack_cache_specs"]


@dataclasses.dataclass
class DecoderCache:
    attn: Optional[list]    # one L.AttnCache per layer, or None
    ssm: Optional[list]     # one M2.SSMCache per layer, or None


def unstack(tree):
    """The per-layer views of a nested dict of stacked leaves: a list with
    one dict per index of the leading axis. Each leaf is split once by
    ``unbind(0)``, so under autograd its gradient is stacked once (one
    ``UnbindBackward``), where indexing each layer would build and sum one
    zero tensor of the whole stacked leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _save_products(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy: keep the products' outputs, recompute the
    rest (the reference saves its dots, ``checkpoint_dots_with_no_batch_dims``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, cfg: ArchConfig, mode: str):
    """``fn`` under activation checkpointing when a training forward records
    a graph: ``"full"`` saves only ``fn``'s inputs and recomputes its body
    in the backward, ``"dots"`` also saves the products' outputs. Outside
    training, without grad, or at ``"none"``, ``fn`` itself."""
    if mode != "train" or cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        contexts = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _save_products)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=contexts)
    raise ValueError(f"remat={cfg.remat!r}; expected none, full or dots")


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

def _block_specs(cfg: ArchConfig, tp_size: int):
    if cfg.family == "ssm":
        return {"norm1": L.norm_specs(cfg), "mamba": M2.mamba2_specs(cfg, tp_size)}
    s = {"norm1": L.norm_specs(cfg), "attn": L.attention_specs(cfg, tp_size)}
    if not cfg.parallel_block:
        s["norm2"] = L.norm_specs(cfg)
    if cfg.is_moe:
        s["moe"] = MOE.moe_specs(cfg, tp_size)
    else:
        s["mlp"] = L.mlp_specs(cfg)
    return s


def stack_param_specs(cfg: ArchConfig, tp_size: int = 0):
    """Logical axes of ``init_stack_params``'s tree (layers stacked)."""
    s = {"embed": L.embedding_specs(cfg),
         "layers": L.stacked_specs(_block_specs(cfg, tp_size)),
         "final_norm": L.norm_specs(cfg)}
    if not cfg.tie_embeddings:
        s["lm_head"] = {"w": ("fsdp", "tp")}
    return s


def attn_cache_spec(cfg: ArchConfig, tp_size: int, seq_len: int, *, window: int):
    """One attention site's cache: KV heads take tp when divisible, else the
    sequence takes "sp" (flash-decoding's combine). ``window`` is the
    cache's ring size as ``init_attn_cache`` sets it for ``seq_len``."""
    kv_ax = "tp" if (tp_size and cfg.n_kv % tp_size == 0) else None
    spec = ("dp", None if kv_ax == "tp" else "sp", kv_ax, None)
    return L.AttnCache(k=spec, v=spec, length=(),
                       window=window if (window and seq_len and window < seq_len) else 0)


def stack_cache_specs(cfg: ArchConfig, tp_size: int = 0, seq_len: int = 0):
    """Logical axes of ``init_stack_cache``'s tree: one spec a layer, each the
    reference's stacked spec without its leading layer axis. ``seq_len`` is
    the cache's ``max_seq``."""
    n = cfg.n_layers
    if cfg.family == "ssm":
        return DecoderCache(attn=None, ssm=[M2.SSMCache(
            state=("dp", "tp", None, None), conv=("dp", None, "tp"), length=())
            for _ in range(n)])
    return DecoderCache(attn=[attn_cache_spec(cfg, tp_size, seq_len, window=cfg.swa_window)
                              for _ in range(n)], ssm=None)


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
    """The table's rows for ``tokens``, in the activation dtype, batch over
    dp (the reference's hint after the lookup in stack, hybrid and encdec).
    The lookup is ``F.embedding``: its backward sums each row's gradient in
    a fixed order, where indexing's (an accumulating ``index_put_``) does
    not on a multi-threaded CPU."""
    # over a mesh the table is first gathered whole: a lookup in a table
    # sharded by vocab leaves DTensor a masked partial sum, which it cannot
    # reduce when d shares a mesh dim with the tokens' rows, nor take a
    # partial gradient back into in a microbatched backward
    table = replicated(params["embed"]["table"], site="embed_table")
    x = F.embedding(tokens.long(), table).to(cfg.activation_dtype)
    return shard_hint(x, "dp", None, None)


def lm_logits(params, x, cfg: ArchConfig):
    """Final norm, then the (tied or separate) output projection; logits
    batch over dp and vocab over tp (the reference's hint)."""
    x = L.norm_apply(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    return shard_hint(logits, "dp", None, "tp")


def compute_weights(layers, cfg: ArchConfig):
    """The layer parameters the loop reads: under ``bf16_compute_weights``
    every fp32 leaf cast to bf16 once, before the loop, so FSDP gathers
    move bf16 (the masters stay fp32 in the optimizer); else ``layers``."""
    if not cfg.bf16_compute_weights:
        return layers
    if isinstance(layers, dict):
        return {k: compute_weights(v, cfg) for k, v in layers.items()}
    return layers.to(torch.bfloat16) if layers.dtype == torch.float32 else layers


def stack_forward(params, tokens, cfg: ArchConfig, *, mode="train",
                  cache: Optional[DecoderCache] = None):
    """tokens [B, T] int; returns (logits [B, T, V], cache', aux)."""
    x = embed_tokens(params, tokens, cfg)
    B, T = x.shape[:2]
    positions = None      # decode takes its position from the cache
    if cfg.family != "ssm" and mode != "decode":
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = remat(_block_apply, cfg, mode)
    ac_new, sc_new = [], []
    for i, lp in enumerate(unstack(compute_weights(params["layers"], cfg))):
        aci = cache.attn[i] if cache is not None and cache.attn is not None else None
        sci = cache.ssm[i] if cache is not None and cache.ssm is not None else None
        x, aci, sci, a = block(lp, x, cfg, positions=positions, mode=mode, attn_cache=aci,
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
