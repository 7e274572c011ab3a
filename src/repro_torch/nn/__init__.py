"""Building blocks of the port (RoPE, norms, FFNs, attention, MoE,
embedding bags)."""
