"""Core model, CTDG and graph-difference modules of the port."""
