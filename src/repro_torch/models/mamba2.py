"""Mamba2 (SSD — state-space duality) block: chunked-scan train/prefill and
O(1)-state recurrent decode (the port of ``repro.models.mamba2``).

Discrete SSD recurrence per head (state N = ssm_state, head dim P):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T     h in R^{P x N}
    y_t = h_t C_t + D x_t

Train and prefill use the chunked matmul form (Mamba2 paper Sec. 6): the
sequence is split into chunks of length ``ssm_chunk``; intra-chunk
contributions are a masked [cl, cl] decay product, the inter-chunk state is
carried by a loop over chunks.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .sharding import local_map

__all__ = ["init_mamba2", "mamba2_apply", "init_ssm_cache", "SSMCache", "mamba2_specs"]


@dataclasses.dataclass
class SSMCache:
    state: torch.Tensor     # [B, H, P, N] float32
    conv: torch.Tensor      # [B, conv_w - 1, conv_dim]
    length: int = 0


def _dims(cfg):
    di = cfg.d_inner
    nh = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = di + 2 * N          # conv over (x, B, C); n_groups = 1
    return di, nh, P, N, conv_dim


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) everywhere (``F.softplus`` turns
    linear past its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba2(gen, cfg, *, lead=(), device="cpu"):
    d = cfg.d_model
    di, nh, P, N, conv_dim = _dims(cfg)
    d_in_proj = 2 * di + 2 * N + nh        # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand(lead + (nh,), generator=gen, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": torch.randn(lead + (d, d_in_proj), generator=gen, **f32) / math.sqrt(d),
        "conv_w": torch.randn(lead + (cfg.ssm_conv, conv_dim), generator=gen, **f32) * 0.1,
        "conv_b": torch.zeros(lead + (conv_dim,), **f32),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)).expand(lead + (nh,)).clone(),
        "D": torch.ones(lead + (nh,), **f32),
        "dt_bias": dt_bias,
        "norm_scale": torch.ones(lead + (di,), **f32),
        "out_proj": torch.randn(lead + (di, d), generator=gen, **f32) / math.sqrt(di),
    }


def mamba2_specs(cfg, tp_size: int = 0):
    """Logical axes of the block's weights (heads and channels on tp)."""
    return {"in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"), "conv_b": ("tp",),
            "A_log": ("tp",), "D": ("tp",), "dt_bias": ("tp",), "norm_scale": ("tp",),
            "out_proj": ("tp", "fsdp")}


def _split_proj(zxbcdt, cfg):
    di, nh, P, N, conv_dim = _dims(cfg)
    z = zxbcdt[..., :di]
    rest = zxbcdt[..., di:di + conv_dim]     # (x, B, C) -> conv input
    dt = zxbcdt[..., di + conv_dim:]
    return z, rest, dt


def _gated_rmsnorm(y, z, scale, eps):
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _causal_conv(x, w, b):
    """x [B, T, C], depthwise causal conv, kernel w [K, C]."""
    K = w.shape[0]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + pads[:, i:i + x.shape[1]].float() * w[i]
    return F.silu(out + b).to(x.dtype)


def _ssd_chunked(xh, dt, A, B_, C_, chunk):
    """Chunked SSD scan.

    xh [B, T, H, P]; dt [B, T, H] (post-softplus); A [H] (negative);
    B_, C_ [B, T, N] (n_groups=1, shared across heads). Returns
    (y [B, T, H, P], h_last [B, H, P, N]), both fp32.
    """
    Bsz, T, H, P = xh.shape
    N = B_.shape[-1]
    nc = T // chunk
    cl = chunk
    xc = xh.reshape(Bsz, nc, cl, H, P).float()
    dtc = dt.reshape(Bsz, nc, cl, H).float()
    Bc = B_.reshape(Bsz, nc, cl, N).float()
    Cc = C_.reshape(Bsz, nc, cl, N).float()
    dA = dtc * A[None, None, None, :]                   # [B, nc, cl, H] (<= 0)
    cum = torch.cumsum(dA, dim=2)                       # within-chunk cumsum
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=xh.device))
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        xck, dtck, Bck, Cck, cumk = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], cum[:, c]
        # intra-chunk: decay matrix Lij = exp(cum_i - cum_j) for i >= j
        diff = cumk[:, :, None, :] - cumk[:, None, :, :]          # [B, cl, cl, H]
        Lm = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        # scores: (C_i . B_j) * L_ij * dt_j
        cb = torch.einsum("bin,bjn->bij", Cck, Bck)               # [B, cl, cl]
        w = cb[:, :, :, None] * Lm * dtck[:, None, :, :]          # [B, cl, cl, H]
        y_diag = torch.einsum("bijh,bjhp->bihp", w, xck)
        # contribution of the carried state: y_i += exp(cum_i) * C_i h_prev
        decay_in = torch.exp(cumk)                                # [B, cl, H]
        y_off = torch.einsum("bin,bhpn->bihp", Cck, h) * decay_in[..., None]
        # new carried state
        tot = cumk[:, -1, :]                                      # [B, H]
        decay_out = torch.exp(tot[:, None, :] - cumk)             # [B, cl, H]
        contrib = torch.einsum("bjh,bjn,bjhp->bhpn", decay_out * dtck, Bck, xck)
        h = torch.exp(tot)[:, :, None, None] * h + contrib
        ys.append(y_diag + y_off)
    return torch.stack(ys, dim=1).reshape(Bsz, T, H, P), h


def init_ssm_cache(cfg, batch, dtype=torch.float32, *, device="cpu"):
    di, nh, P, N, conv_dim = _dims(cfg)
    return SSMCache(
        state=torch.zeros((batch, nh, P, N), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        length=0,
    )


def mamba2_apply(p, x, cfg, *, mode="train", cache: SSMCache | None = None):
    """x [B, T, d] -> (y [B, T, d], cache'). Over a mesh the block runs on
    each rank's batch rows with its weights gathered whole (``local_map``):
    its in_proj's output concatenates z, x, B, C and dt, which no tp split
    of the columns keeps apart, and its chunk loop's small ops would each
    pay DTensor's dispatch; every tp rank computes the same rows."""
    names = sorted(p)
    state = () if cache is None else (cache.state, cache.conv)
    keep = mode != "train"    # prefill and decode return a new cache
    length = []

    def run(x, *leaves):
        c = None if cache is None else SSMCache(state=leaves[-2], conv=leaves[-1],
                                                length=cache.length)
        out, new = _mamba2_apply(dict(zip(names, leaves)), x, cfg, mode=mode, cache=c)
        if not keep:
            return (out,)
        length.append(new.length)
        return out, new.state, new.conv

    got = local_map(run, (x, *(p[n] for n in names), *state),
                    [("dp",)] + [()] * len(names) + [("dp",)] * len(state),
                    [("dp",)] * (3 if keep else 1), site="mamba2_block")
    if not keep:
        return got[0], cache
    return got[0], SSMCache(state=got[1], conv=got[2], length=length[0])


def _mamba2_apply(p, x, cfg, *, mode="train", cache: SSMCache | None = None):
    """x [B, T, d] -> (y [B, T, d], cache')."""
    Bsz, T, d = x.shape
    di, nh, P, N, conv_dim = _dims(cfg)
    dtype = x.dtype
    zxbcdt = x @ p["in_proj"].to(dtype)
    z, conv_in, dt_raw = _split_proj(zxbcdt, cfg)

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError("mamba2 decode takes one token and a cache")
        # roll the conv window
        window = torch.cat([cache.conv, conv_in.to(cache.conv.dtype)], dim=1)
        conv_out = (window.float() * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
        conv_out = F.silu(conv_out)[:, None, :]                 # [B, 1, conv_dim]
        new_conv = window[:, 1:]
        xh = conv_out[..., :di].reshape(Bsz, nh, P).float()
        B_ = conv_out[..., di:di + N].reshape(Bsz, N).float()
        C_ = conv_out[..., di + N:].reshape(Bsz, N).float()
        dtv = _softplus(dt_raw[:, 0].float() + p["dt_bias"])    # [B, H]
        A = -torch.exp(p["A_log"])
        dA = torch.exp(dtv * A)                                 # [B, H]
        upd = torch.einsum("bh,bn,bhp->bhpn", dtv, B_, xh)
        state = cache.state * dA[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, C_) + p["D"][None, :, None] * xh
        y = y.reshape(Bsz, 1, di).to(dtype)
        y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
        out = y @ p["out_proj"].to(dtype)
        return out, SSMCache(state=state, conv=new_conv, length=cache.length + 1)

    # train / prefill: chunked scan
    chunk = min(cfg.ssm_chunk, T)
    pad = (-T) % chunk
    if pad and mode == "prefill":
        raise ValueError("prefill length must be a multiple of ssm_chunk "
                         "(padding would corrupt the carried state)")
    if pad:
        conv_in = F.pad(conv_in, (0, 0, 0, pad))
        dt_raw = F.pad(dt_raw, (0, 0, 0, pad))
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    Tp = T + pad
    xh = conv_out[..., :di].reshape(Bsz, Tp, nh, P)
    B_ = conv_out[..., di:di + N]
    C_ = conv_out[..., di + N:]
    dtv = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_last = _ssd_chunked(xh, dtv, A, B_, C_, chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(Bsz, Tp, di)[:, :T].to(dtype)
    y = _gated_rmsnorm(y, z[:, :T], p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dtype)
    new_cache = cache
    if mode == "prefill":
        # the last (conv_w - 1) raw conv inputs feed the first decode steps
        hist = torch.cat([torch.zeros((Bsz, cfg.ssm_conv - 1, conv_dim), dtype=conv_in.dtype,
                                      device=x.device), conv_in[:, :T]], dim=1)
        new_cache = SSMCache(state=h_last, conv=hist[:, -(cfg.ssm_conv - 1):], length=T)
    return out, new_cache
