"""Chip configurations."""
