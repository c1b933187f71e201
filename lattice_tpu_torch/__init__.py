"""lattice_tpu_torch: the PyTorch/CUDA port of `lattice_tpu` for NVIDIA Hopper.

The JAX package `lattice_tpu` is the reference and stays as it is; this
package mirrors its module paths (`index/chunk_store.py` <->
`index/chunk_store.py`, ...), with one rename: `ops/pallas_topk.py`
becomes `ops/scan_topk.py`. It imports torch, numpy and the standard
library only. The hand-written CUDA kernels live in `csrc/` and are
compiled for `sm_90a` at first use (`ops/_build.py`).

Ported so far: the vector-search core of the main path
(ChunkStore -> int8 / bf16 scan kernels -> exact rescore), the IVF tier,
the hash embedding provider, the vector indexer/searcher, and the
UniXcoder encoder's serving path (tokenizer -> RoBERTa-base module with
the paired-attention kernel -> provider).
"""

__version__ = "0.1.0"
