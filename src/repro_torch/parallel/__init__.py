"""Mesh-axis helpers for the multi-rank model paths."""
