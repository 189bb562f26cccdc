"""Serving: request batching, the paged KV pool and spill store, the
continuous engine and the space-ground schedulers."""
