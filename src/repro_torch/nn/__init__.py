"""Transformer building blocks of the port (RoPE, norms, FFNs, attention)."""
