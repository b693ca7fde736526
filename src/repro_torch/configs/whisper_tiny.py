"""whisper-tiny [audio]: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865
— encoder-decoder, conv frontend STUB (input_specs provides precomputed
frame embeddings) [arXiv:2212.04356; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,        # decoder layers
    enc_layers=4,
    enc_frames=1500,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    mlp_glu=False,
    attn_bias=True,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, enc_frames=16, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=256, dtype="float32", remat="none")
