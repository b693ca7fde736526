from .ops import INVALID, blockify_entries, bucket_probe
from .ref import bucket_probe_ref

__all__ = ["bucket_probe", "bucket_probe_ref", "blockify_entries", "INVALID"]
