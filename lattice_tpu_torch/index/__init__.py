from lattice_tpu_torch.index.chunk_store import ChunkStore

__all__ = ["ChunkStore"]
