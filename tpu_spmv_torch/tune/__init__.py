"""Kernel and layout planning."""
