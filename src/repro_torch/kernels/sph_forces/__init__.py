"""Fused SPH density+momentum tile forces: thin wrappers over the cell-pair
engine."""
