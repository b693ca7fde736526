from .ops import INVALID, blockify_entries, probe_append
from .ref import bucket_probe_ref, probe_append_ref

__all__ = ["probe_append", "probe_append_ref", "bucket_probe_ref", "blockify_entries",
           "INVALID"]
