"""Time integrators."""
