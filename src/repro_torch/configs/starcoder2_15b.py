"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE, LayerNorm + bias, plain-GELU MLP
[arXiv:2402.19173; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    d_ff=24576,
    vocab=49152,
    rope_theta=100000.0,
    act="gelu",
    norm="layernorm",
    mlp_glu=False,
    attn_bias=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=256,
        vocab=256, dtype="float32", remat="none")
