"""Synthetic relation generators."""
