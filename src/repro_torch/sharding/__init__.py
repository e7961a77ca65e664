"""Logical-axis sharding of the LM on the port's meshes (``repro``'s
``sharding/``)."""
