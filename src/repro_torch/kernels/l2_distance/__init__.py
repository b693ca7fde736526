from .ops import l2_distance, l2_distance_by_id
from .ref import l2_distance_by_id_ref, l2_distance_gathered_ref, l2_distance_ref

__all__ = ["l2_distance", "l2_distance_by_id", "l2_distance_by_id_ref",
           "l2_distance_gathered_ref", "l2_distance_ref"]
