"""Training step factories and evaluation of the port."""
