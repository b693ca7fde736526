"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=11008,
    vocab=102400,
    rope_theta=10000.0,
    act="silu",
    norm="rmsnorm",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=160,
        vocab=256, dtype="float32", remat="none")
