"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. ``KERNELS`` holds one launcher per kernel; its ``launches`` count
shows which kernels a run went through."""
from .bucket_probe import (INVALID, blockify_entries, bucket_probe,
                           bucket_probe_ref)
from .bucket_probe.ops import KERNEL as _BUCKET_PROBE
from .l2_distance import (l2_distance, l2_distance_gathered,
                          l2_distance_gathered_ref, l2_distance_ref)
from .l2_distance.ops import DENSE_KERNEL as _L2_DISTANCE_DENSE
from .l2_distance.ops import KERNEL as _L2_DISTANCE
from .lsh_hash import lsh_hash_all_radii, lsh_hash_all_radii_ref, lsh_hash_ref
from .lsh_hash.ops import KERNEL as _LSH_HASH

KERNELS = (_LSH_HASH, _BUCKET_PROBE, _L2_DISTANCE, _L2_DISTANCE_DENSE)

__all__ = [
    "KERNELS", "INVALID", "blockify_entries", "bucket_probe", "bucket_probe_ref",
    "l2_distance", "l2_distance_gathered", "l2_distance_gathered_ref",
    "l2_distance_ref", "lsh_hash_all_radii", "lsh_hash_all_radii_ref",
    "lsh_hash_ref",
]
