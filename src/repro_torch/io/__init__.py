"""Checkpoint/restart and VTK output (paper §3.7)."""
