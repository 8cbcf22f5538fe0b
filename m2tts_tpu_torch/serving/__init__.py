"""Bucketed batch synthesis."""
