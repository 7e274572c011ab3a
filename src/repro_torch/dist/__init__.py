"""Distribution utilities of the port: communication-volume laws
(``comm_volume``) and the process-group rank layout with its counted
all-to-alls (``sharding``)."""
