"""Elasticity: heartbeats, stragglers and re-partitioning on worker loss."""
