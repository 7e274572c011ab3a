"""Graph primitives and generators of the port."""
