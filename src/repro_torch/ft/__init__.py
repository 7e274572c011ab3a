"""Fault tolerance of the port: preemption, re-meshing and the
snapshot-axis re-blocking (``elastic``), and the straggler watchdog
(``straggler``)."""
