"""Distribution utilities of the port: communication-volume laws
(``comm_volume``), the process-group rank layout with its counted
all-to-alls (``sharding``), the int8 error-feedback wire of the
collectives (``compression``) and the overlap time models
(``overlap``)."""
