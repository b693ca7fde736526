"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel attention/MLP block,
LayerNorm, tied embeddings [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=33792,
    vocab=256000,
    rope_theta=75000.0,
    act="silu",
    norm="layernorm",
    parallel_block=True,
    use_qk_norm=True,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=192,
        vocab=256, dtype="float32", remat="none")
