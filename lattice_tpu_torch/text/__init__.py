"""Host-side text handling: tokenization for the encoder."""
