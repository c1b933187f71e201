"""Host-side utilities: span tracing and device-trace summaries."""
