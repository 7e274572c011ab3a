"""Models of the port (the decoder-only LM family, the static GNNs, DIN)."""
