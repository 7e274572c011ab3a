"""The static-graph GNNs: GatedGCN, PNA, SchNet and EquiformerV2."""
