"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]. The shared transformer block is applied every 6
backbone layers with tied weights (per-site LoRAs omitted; see DESIGN.md)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=10240,
    vocab=32000,
    rope_theta=10000.0,
    act="gelu",
    norm="rmsnorm",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
        shared_attn_every=2, dtype="float32", remat="none")
