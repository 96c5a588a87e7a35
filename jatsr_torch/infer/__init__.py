from .pipeline import InferencePipeline, chunk_plan, crossfade_chunks

__all__ = ["InferencePipeline", "chunk_plan", "crossfade_chunks"]
