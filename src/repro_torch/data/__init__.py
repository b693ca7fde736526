from .synthetic import DATASETS, Dataset, make_dataset, nn_scale

__all__ = ["DATASETS", "Dataset", "make_dataset", "nn_scale"]
