"""Dynamic-graph datasets and the host data pipeline of the port."""
