"""Banded-TTM (TM-GCN M-product) kernel: wrapper, plain version."""
