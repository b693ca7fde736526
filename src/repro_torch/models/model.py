"""Unified model API over the families (the port of ``repro.models.model``).

    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, aux = model.forward_train(params, batch)        # [B, T, V]
    cache = model.init_cache(batch, max_seq, dtype)
    logits, cache = model.prefill(params, inputs, cache)
    logits, cache = model.decode_step(params, tokens, cache)

``forward_train`` is differentiable: ``repro_torch.training`` takes its
gradients by autograd over the fp32 master leaves, with each layer under
activation checkpointing as ``cfg.remat`` says. ``param_specs()`` and
``cache_specs()`` return trees of *logical* axis tuples over the parameter
and cache trees (resolved against a mesh by ``models.sharding.AxisRules``).
"""
from __future__ import annotations

import torch

from ..kernels.dispatch import resolve_device
from . import encdec as ED
from . import hybrid as HY
from . import stack as ST
from .config import ArchConfig

__all__ = ["Model", "is_spec_leaf"]


def is_spec_leaf(x) -> bool:
    """A spec tree's leaf: one tuple of logical axes."""
    return isinstance(x, tuple)


class Model:
    def __init__(self, cfg: ArchConfig, *, device=None):
        """``device`` None -> cuda; raises without a GPU unless "cpu"."""
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- params -------------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random parameters of the reference's shapes and scales, fp32,
        drawn on the model's device from ``generator`` (which must live
        there)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg, kw = self.cfg, dict(device=self.device)
        if cfg.family == "hybrid":
            return HY.init_hybrid_params(generator, cfg, **kw)
        if cfg.family == "encdec":
            return ED.init_encdec_params(generator, cfg, **kw)
        return ST.init_stack_params(generator, cfg, **kw)

    def param_specs(self, tp_size: int = 0):
        cfg = self.cfg
        if cfg.family == "hybrid":
            return HY.hybrid_param_specs(cfg, tp_size)
        if cfg.family == "encdec":
            return ED.encdec_param_specs(cfg, tp_size)
        return ST.stack_param_specs(cfg, tp_size)

    def cache_specs(self, tp_size: int = 0, seq_len: int = 0):
        """``seq_len`` is the cache's ``max_seq`` (it sets the window)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return HY.hybrid_cache_specs(cfg, tp_size, seq_len)
        if cfg.family == "encdec":
            return ED.encdec_cache_specs(cfg, tp_size, seq_len)
        return ST.stack_cache_specs(cfg, tp_size, seq_len)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- training forward -----------------------------------------------------
    def forward_train(self, params, batch):
        """batch: {"tokens": [B, T]} (+ "frames" for encdec). Returns
        (logits, aux)."""
        cfg = self.cfg
        tokens = self._tensor(batch["tokens"])
        if cfg.family == "hybrid":
            logits, _, aux = HY.hybrid_forward(params, tokens, cfg, mode="train")
        elif cfg.family == "encdec":
            enc_out = ED.encode(params, self._tensor(batch["frames"]), cfg)
            logits, _, aux = ED.decode_forward(params, tokens, enc_out, cfg, mode="train")
        else:
            logits, _, aux = ST.stack_forward(params, tokens, cfg, mode="train")
        return logits, aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        cfg, kw = self.cfg, dict(device=self.device)
        if cfg.family == "hybrid":
            return HY.init_hybrid_cache(cfg, batch, max_seq, dtype, **kw)
        if cfg.family == "encdec":
            return ED.init_encdec_cache(cfg, batch, max_seq, dtype, **kw)
        return ST.init_stack_cache(cfg, batch, max_seq, dtype, **kw)

    def prefill(self, params, batch, cache):
        """Run the prompt through the model, filling the cache. Returns
        (last-position logits [B, 1, V], cache')."""
        cfg = self.cfg
        tokens = self._tensor(batch["tokens"])
        if cfg.family == "hybrid":
            logits, cache, _ = HY.hybrid_forward(params, tokens, cfg, mode="prefill",
                                                 cache=cache)
        elif cfg.family == "encdec":
            enc_out = ED.encode(params, self._tensor(batch["frames"]), cfg)
            logits, cache, _ = ED.decode_forward(params, tokens, enc_out, cfg,
                                                 mode="prefill", cache=cache)
        else:
            logits, cache, _ = ST.stack_forward(params, tokens, cfg, mode="prefill",
                                                cache=cache)
        return logits[:, -1:], cache

    def decode_step(self, params, tokens, cache):
        """tokens [B, 1] -> (logits [B, 1, V], cache')."""
        cfg = self.cfg
        tokens = self._tensor(tokens)
        if cfg.family == "hybrid":
            logits, cache, _ = HY.hybrid_forward(params, tokens, cfg, mode="decode",
                                                 cache=cache)
        elif cfg.family == "encdec":
            logits, cache, _ = ED.decode_forward(params, tokens, None, cfg, mode="decode",
                                                 cache=cache)
        else:
            logits, cache, _ = ST.stack_forward(params, tokens, cfg, mode="decode",
                                                cache=cache)
        return logits, cache

    # -- convenience ----------------------------------------------------------
    @staticmethod
    def param_count(params) -> int:
        if isinstance(params, dict):
            return sum(Model.param_count(v) for v in params.values())
        return params.numel()
