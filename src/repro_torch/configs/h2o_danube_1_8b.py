"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention
[arXiv:2401.16818; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_ff=6912,
    vocab=32000,
    rope_theta=10000.0,
    swa_window=4096,
    act="silu",
    norm="rmsnorm",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160,
        vocab=256, swa_window=32, dtype="float32", remat="none")
