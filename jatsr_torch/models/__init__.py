from .dit import DiT, adaln_tables

__all__ = ["DiT", "adaln_tables"]
