"""Errors shared by the port (a copy of `lattice_tpu.core.errors`)."""
