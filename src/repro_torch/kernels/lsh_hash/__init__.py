from .ops import lsh_hash_all_radii, lsh_hash_lookup
from .ref import lsh_hash_all_radii_ref, lsh_hash_lookup_ref, lsh_hash_ref

__all__ = ["lsh_hash_all_radii", "lsh_hash_lookup", "lsh_hash_ref", "lsh_hash_all_radii_ref",
           "lsh_hash_lookup_ref"]
