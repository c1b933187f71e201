"""Measurement tools that run on the card (`python -m lattice_tpu_torch.tools.<name>`)."""
