"""Indexed projects: the registry-backed repository and its manager."""
