"""Embedding providers (the hash provider and its base class)."""
