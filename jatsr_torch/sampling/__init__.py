from .flow import FlowSampler

__all__ = ["FlowSampler"]
