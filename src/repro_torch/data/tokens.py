"""Deterministic synthetic LM token pipeline (the port of
``repro.data.tokens``).

Stateless-by-step: batch(step, shard) is a pure function of (seed, step,
shard), so the pipeline is trivially checkpointable (the state is the step
counter), elastic (reshard = re-partition shard ids) and skew-free across
data-parallel ranks. Tokens follow a Zipf-like marginal with short-range
repetition structure so cross-entropy is learnable. ``_batch_np`` is the
reference's numpy code, so both packages draw the same tokens bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.dispatch import resolve_device

__all__ = ["TokenPipeline", "TokenPipelineState"]


@dataclasses.dataclass
class TokenPipelineState:
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @staticmethod
    def from_dict(d):
        return TokenPipelineState(step=int(d["step"]))


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, num_shards: int = 1, shard: int = 0, device=None):
        """``device`` None -> cuda; raises without a GPU unless "cpu"."""
        if global_batch % num_shards:
            raise ValueError(f"global_batch {global_batch} is not a multiple of "
                             f"num_shards {num_shards}")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.num_shards = num_shards
        self.shard = shard
        self.device = resolve_device(device)

    def _batch_np(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        B, T, V = self.local_batch, self.seq_len, self.vocab_size
        # Zipf-ish marginal
        base = rng.zipf(1.3, size=(B, T)).astype(np.int64)
        toks = (base - 1) % V
        # inject learnable structure: token t+1 = f(token t) on half positions
        nxt = (toks * 31 + 7) % V
        mask = rng.random((B, T)) < 0.5
        toks[:, 1:] = np.where(mask[:, 1:], nxt[:, :-1], toks[:, 1:])
        return toks.astype(np.int32)

    def next_batch(self, state: TokenPipelineState):
        """(batch, state'): ``tokens`` and ``targets`` (tokens shifted left,
        wrapping) int32 and ``mask`` float32, on the pipeline's device."""
        toks = self._batch_np(state.step)
        batch = {
            "tokens": torch.from_numpy(toks).to(self.device),
            "targets": torch.from_numpy(np.roll(toks, -1, axis=1)).to(self.device),
            "mask": torch.ones(toks.shape, dtype=torch.float32, device=self.device),
        }
        return batch, TokenPipelineState(step=state.step + 1)
