"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,          # unused (attention-free)
    n_kv=1,
    d_ff=0,             # no MLP; the Mamba2 mixer is the whole block
    vocab=50280,
    norm="rmsnorm",
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=32, dtype="float32", remat="none")
