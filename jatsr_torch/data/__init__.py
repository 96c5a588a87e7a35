from .dataset import load_stats

__all__ = ["load_stats"]
