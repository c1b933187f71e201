"""The persisted index (`persistence`) and the host SQLite client
(`database`)."""
