"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=16384,
    vocab=32768,
    rope_theta=1000000.0,
    swa_window=4096,
    act="silu",
    norm="rmsnorm",
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=16384,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        moe_d_ff=128, moe_experts=4, moe_top_k=2, vocab=256, swa_window=32,
        dtype="float32", remat="none")
