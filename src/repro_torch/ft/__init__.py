"""Fault tolerance of the port: for now only the snapshot-axis re-blocking
(``elastic.dyngnn_elastic_blocks``)."""
