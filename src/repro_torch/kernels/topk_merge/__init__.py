from .ops import MAX_ENTRIES, topk_merge
from .ref import merge_topk_ref, topk_merge_ref

__all__ = ["topk_merge", "topk_merge_ref", "merge_topk_ref", "MAX_ENTRIES"]
