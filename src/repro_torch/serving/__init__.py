"""Serving: request batching, the paged KV pool and the continuous engine."""
