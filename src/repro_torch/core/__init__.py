"""Particle container, cell lists, pair engine and the simulation layer."""
