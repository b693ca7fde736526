"""Baselines of the paper's evaluation: the exact k-NN scan (the ground
truth of the overall ratio) and the small-index methods SRS and QALSH."""
from .exact import exact_knn, exact_knn_np
from .srs import SRSIndex, build_srs, srs_query
from .qalsh import QALSHIndex, build_qalsh, qalsh_query

__all__ = ["exact_knn", "exact_knn_np", "SRSIndex", "build_srs", "srs_query",
           "QALSHIndex", "build_qalsh", "qalsh_query"]
