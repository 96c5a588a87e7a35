from .pipeline import (InferencePipeline, chunk_plan, crossfade_chunks,
                       group_noise, split_serve_devices)

__all__ = ["InferencePipeline", "chunk_plan", "crossfade_chunks",
           "group_noise", "split_serve_devices"]
