"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens share the vocab; modality
frontend is a STUB (token ids only) [arXiv:2405.09818; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22016,
    vocab=65536,
    rope_theta=10000.0,
    act="silu",
    norm="rmsnorm",
    use_qk_norm=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160,
        vocab=256, dtype="float32", remat="none")
