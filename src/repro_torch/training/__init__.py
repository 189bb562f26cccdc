"""Training pieces of the port: the AdamW of the JAX package's ``training/optim.py``."""
