"""Baselines of the paper's evaluation. The exact k-NN scan is the ground
truth of the overall ratio."""
from .exact import exact_knn, exact_knn_np

__all__ = ["exact_knn", "exact_knn_np"]
