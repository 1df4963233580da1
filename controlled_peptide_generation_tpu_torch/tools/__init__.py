"""Measurement scripts of the port (they need the card)."""
