"""Model substrate (dense family): layers, attention and the transformer."""
