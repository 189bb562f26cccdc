"""Training of the port: AdamW (``optim``), the single-host loop
(``loop``) and the Sedna-style federated, incremental and lifelong
updates, twins of the JAX package's ``training/*``."""
