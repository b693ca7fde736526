"""Plain PyTorch version of the radius fold (``topk_merge``): the top-k
merge with id dedup and the search state's update, as eager tensor
operations. The oracle and host plans run it on every device; the kernel's
wrapper runs it for CPU tensors."""
from __future__ import annotations

import torch

from ..bucket_probe.ref import INVALID

__all__ = ["merge_topk_ref", "topk_merge_ref"]


def merge_topk_ref(best_id, best_d2, new_id, new_d2, k: int):
    """Merge a candidate set into the running top-k with id dedup. Both sorts
    are stable (INVALID = 2^31-1 sorts last), as jnp.argsort is."""
    ids = torch.cat([best_id, new_id], dim=1)
    d2 = torch.cat([best_d2, new_d2], dim=1)
    order = torch.sort(ids, dim=1, stable=True).indices
    ids_s = torch.gather(ids, 1, order)
    d2_s = torch.gather(d2, 1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    dup &= ids_s != INVALID
    d2_s = torch.where(dup, torch.inf, d2_s)
    order2 = torch.sort(d2_s, dim=1, stable=True).indices[:, :k]
    out_d2 = torch.gather(d2_s, 1, order2)
    out_id = torch.gather(ids_s, 1, order2)
    return torch.where(torch.isinf(out_d2), INVALID, out_id), out_d2


def topk_merge_ref(state, cand_id, cand_d2, cnt, blocks_read, count, *, t: int,
                   thresh2: float):
    """Fold one radius' probe results into the running state (done-masked).

    Arguments as ``topk_merge``'s. Returns a new state tuple; the one given
    is left as it was."""
    best_id, best_d2, done, radii_searched, nio_t, nio_b, cands, probe_sizes = state
    k = best_id.shape[1]
    active_q = ~done
    new_id, new_d2 = merge_topk_ref(best_id, best_d2, cand_id, cand_d2, k)
    # queries already done keep their results (the paper reports at the first
    # successful radius)
    best_id = torch.where(done[:, None], best_id, new_id)
    best_d2 = torch.where(done[:, None], best_d2, new_d2)
    within = (best_d2 <= thresh2).sum(dim=1) >= k
    nonempty = (cnt > 0) & active_q[:, None]
    radii_searched = radii_searched + active_q.to(torch.int32)
    nio_t = nio_t + nonempty.sum(dim=1, dtype=torch.int32)
    nio_b = nio_b + blocks_read
    cands = cands + count
    if probe_sizes.dim() == 3:
        probe_sizes = probe_sizes.clone()
        probe_sizes[:, t, :] = torch.where(nonempty, cnt, -1)
    done = done | (within & active_q)
    return best_id, best_d2, done, radii_searched, nio_t, nio_b, cands, probe_sizes
