"""MCP stdio server (torch port of `lattice_tpu/mcp/`)."""
