"""Segment SpMM (GCN aggregate) kernel: wrapper, plain version."""
