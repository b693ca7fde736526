"""E2LSH / E2LSH-on-Storage core, in PyTorch."""
from .probabilities import (LSHParams, collision_probability, radii_schedule,
                            rho, solve_params)
from .hashing import HashFamily, make_hash_family, hash_points_radius_deterministic
from .index import E2LSHIndex, IndexArrays, IndexStats, build_index
from .query import QueryConfig, QueryResult, SearchEngine
from .e2lshos import E2LSHoS, measured_query
from .tuning import TuneResult, overall_ratio, tune_gamma
from . import io_count, storage

__all__ = [
    "LSHParams", "collision_probability", "radii_schedule", "rho", "solve_params",
    "HashFamily", "make_hash_family", "hash_points_radius_deterministic",
    "E2LSHIndex", "IndexArrays", "IndexStats", "build_index",
    "QueryConfig", "QueryResult", "SearchEngine",
    "E2LSHoS", "measured_query", "overall_ratio", "tune_gamma", "TuneResult",
    "io_count", "storage",
]
