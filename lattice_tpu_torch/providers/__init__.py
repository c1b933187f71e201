"""Embedding providers: the hash provider, the UniXcoder encoder, and
their base class."""
