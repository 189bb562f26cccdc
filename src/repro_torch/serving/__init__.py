"""Serving: request batching, the paged KV pool, prefix index and spill
store, the continuous engine, the space-ground schedulers, draft-verify
decoding and the constellation scheduler."""
