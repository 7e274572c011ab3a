"""Architecture registry of the port (dyngnn, LM and static-GNN archs)."""
