"""Graph-domain quality metrics of the port."""
