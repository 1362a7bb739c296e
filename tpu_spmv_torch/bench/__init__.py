"""Timing and validation on the card."""
