"""Placement of the flat substrate over a mesh of ranks."""
