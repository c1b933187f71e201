"""The benchmark of lattice_tpu_torch on one NVIDIA H100: `run.py` runs one
cell of `BENCHMARK.json` once (see README.md). Nothing here imports jax or
the JAX package; the references under `reference/` import nothing of the
port either."""
