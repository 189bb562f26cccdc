"""Data generators of the port (copies of the JAX package's numpy-only ``data``)."""
