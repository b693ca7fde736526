"""LM decode with E2LSHoS retrieval (kNN-LM-style composition), on the
PyTorch/CUDA port.

Runs a reduced-config LM (pick any of the 10 archs), decodes with a KV (or
SSM) cache, and probes an E2LSH index over a datastore in the logits space
with the decoder output every step. Runs on the GPU unless ``--device cpu``.

    PYTHONPATH=src python examples/retrieval_decode_torch.py --arch mamba2-1.3b
    PYTHONPATH=src python examples/retrieval_decode_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import E2LSHoS
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model
from repro_torch.serving import ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--dstore", type=int, default=4000)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)

    # datastore in the model's logits space (stand-in for context embeddings)
    dstore = rng.normal(size=(args.dstore, cfg.vocab)).astype(np.float32)
    dstore /= np.linalg.norm(dstore, axis=1, keepdims=True)
    index = E2LSHoS.build(dstore, gamma=0.8, max_L=16, device=dev)
    print(f"datastore index: n={args.dstore} L={index.params.L} m={index.params.m}")

    def retrieve(hidden):
        h = hidden.float()
        h = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=1, keepdim=True), 1e-9)
        res = index.query(h, k=args.k)
        return res.ids, res.dists

    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(dev)
    eng = ServeEngine(model, params, max_seq=64, cache_dtype=torch.float32,
                      retrieval_fn=retrieve, device=dev)
    out = eng.generate(batch, steps=args.steps)
    print("generated tokens:", out.tokens.cpu().numpy())
    print("neighbors per step (ids):")
    print(out.neighbors[0].cpu().numpy())


if __name__ == "__main__":
    main()
