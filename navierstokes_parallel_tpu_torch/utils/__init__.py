"""Timing and runtime checks."""
