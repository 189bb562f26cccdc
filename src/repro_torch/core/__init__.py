"""The confidence gate of the space-ground loop (paper section IV)."""
