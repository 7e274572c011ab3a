"""Architecture registry of the port (dyngnn, LM, static-GNN and recsys
archs)."""
