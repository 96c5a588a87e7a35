from .dataset import (BatchLoader, LatentDataset, ValidationDataset,
                      load_stats)

__all__ = ["BatchLoader", "LatentDataset", "ValidationDataset", "load_stats"]
