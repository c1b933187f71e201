"""Project metadata: the models, the SQLite repository and the local
generator."""
