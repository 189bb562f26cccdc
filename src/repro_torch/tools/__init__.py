"""Development tools that run on the card (not used by the port)."""
