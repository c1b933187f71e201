"""Scoring and top-k selection: plain torch code and the CUDA kernels
built from `csrc/`."""
