"""Embedding facade, vector indexer and searcher."""
