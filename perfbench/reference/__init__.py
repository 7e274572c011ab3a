"""Plain PyTorch references the benchmark holds the port to."""
