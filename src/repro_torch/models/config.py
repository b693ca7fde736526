"""Architecture configuration for the model zoo (the port's copy of
``repro.models.config``).

One frozen dataclass describes every family (dense / moe / ssm / hybrid /
encdec); ``repro_torch/configs/<id>.py`` instantiates the exact published
numbers and provides ``reduced()`` for CPU tests. ``activation_dtype`` is a
torch dtype. ``remat`` steers activation checkpointing in a training
forward (``models/stack.py:remat``). The two sharding levers are the
reference's: ``bf16_compute_weights`` casts the layer parameters to bf16
once before the layer loop (``models/stack.py:compute_weights``), and
``moe_shard_capacity`` shards the MoE dispatch buffer's capacity dim over
tp (``models/moe.py``). The reference's other execution fields
(``scan_layers``, ``max_seq``) steer XLA's compilation; nothing here reads
them, so they are not fields.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned input-shape set (LM family): seq_len x global_batch.
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0      # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    swa_window: int = 0    # 0 = full attention; >0 = sliding-window
    norm_eps: float = 1e-5
    act: str = "silu"      # silu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    use_qk_norm: bool = False
    parallel_block: bool = False   # command-r style: attn and MLP in parallel
    attn_bias: bool = False
    mlp_glu: bool = True           # gated (SwiGLU) vs plain 2-matrix MLP
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden width
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2 backbone)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2): shared transformer block applied every k backbone layers
    shared_attn_every: int = 0
    # enc-dec (whisper): encoder layers; frontend is a stub (frame embeddings)
    enc_layers: int = 0
    enc_frames: int = 1500
    # numerics: activations (weights are fp32 masters cast at each use)
    dtype: str = "bfloat16"
    remat: str = "full"    # none | full | dots: what a training forward saves
    # sharding levers (the reference's perf levers)
    bf16_compute_weights: bool = False  # cast layer params to bf16 before the
                                        # layer loop, so FSDP all-gathers move bf16
    moe_shard_capacity: bool = False    # shard MoE dispatch buffers' capacity
                                        # dim over tp (EP-over-capacity)

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def supports_shape(self, shape_name: str) -> tuple:
        """(supported, reason). long_500k needs sub-quadratic attention state:
        SSM/hybrid or SWA archs qualify; pure full-attention archs skip."""
        spec = SHAPES[shape_name]
        if spec.name == "long_500k":
            subquad = self.family in ("ssm", "hybrid") or self.swa_window > 0
            if not subquad:
                return False, "pure full-attention arch: unbounded KV at 500k (skip per assignment)"
        return True, ""

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks); used for roofline
        MODEL_FLOPS = 6*N*D and memory sanity checks."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        H, KV, hd = self.n_heads, self.n_kv, self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        n = emb
        if self.family == "ssm":
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * st
            per = (d * (2 * di + 2 * st + nh)      # in_proj (z,x,B,C,dt)
                   + conv_dim * self.ssm_conv + conv_dim
                   + 3 * nh                        # A_log, D, dt_bias
                   + di                            # gated norm
                   + di * d + d)                   # out_proj + final norm share
            return n + self.n_layers * per + d
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.use_qk_norm:
            attn += 2 * hd
        if self.is_moe:
            e_ff = self.moe_d_ff or ff
            mlp = self.moe_experts * (e_ff * d * (3 if self.mlp_glu else 2)) + d * self.moe_experts
        else:
            mlp = ff * d * (3 if self.mlp_glu else 2)
        norms = 2 * d
        per_layer = attn + mlp + norms
        if self.family == "hybrid":
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * st
            ssm_per = (d * (2 * di + 2 * st + nh) + conv_dim * self.ssm_conv + conv_dim
                       + 3 * nh + di + di * d + 2 * d)
            shared_blocks = 1
            n += self.n_layers * ssm_per + shared_blocks * per_layer + d
            return n
        if self.family == "encdec":
            # decoder layers have an extra cross-attention block
            cross = d * H * hd + 2 * d * KV * hd + H * hd * d + d
            n += self.enc_layers * per_layer + self.n_layers * (per_layer + cross)
            n += 2 * d  # final norms
            return n
        return n + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of experts)."""
        if not self.is_moe:
            return self.param_count()
        e_ff = self.moe_d_ff or self.d_ff
        full_mlp = self.moe_experts * (e_ff * self.d_model * (3 if self.mlp_glu else 2))
        act_mlp = self.moe_top_k * (e_ff * self.d_model * (3 if self.mlp_glu else 2))
        return self.param_count() - self.n_layers * (full_mlp - act_mlp)
