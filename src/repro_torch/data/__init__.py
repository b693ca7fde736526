from .synthetic import DATASETS, Dataset, make_dataset, nn_scale
from .tokens import TokenPipeline, TokenPipelineState

__all__ = ["DATASETS", "Dataset", "make_dataset", "nn_scale",
           "TokenPipeline", "TokenPipelineState"]
