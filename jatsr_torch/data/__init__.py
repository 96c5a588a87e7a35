from .dataset import (BatchLoader, LatentDataset, ValidationDataset,
                      load_stats)
from .preprocess import PreprocessPipeline, compute_separated_stats

__all__ = ["BatchLoader", "LatentDataset", "ValidationDataset", "load_stats",
           "PreprocessPipeline", "compute_separated_stats"]
