from .pipeline import (InferencePipeline, chunk_plan, crossfade_chunks,
                       group_noise)

__all__ = ["InferencePipeline", "chunk_plan", "crossfade_chunks",
           "group_noise"]
