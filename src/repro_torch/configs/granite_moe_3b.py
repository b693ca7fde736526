"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base;
hf]. Note: per-expert hidden width is 512."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    rope_theta=10000.0,
    act="silu",
    norm="rmsnorm",
    moe_experts=40,
    moe_top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=64,
        moe_d_ff=64, moe_experts=8, moe_top_k=4, vocab=256,
        dtype="float32", remat="none")
