"""Applications written against the simulation layer."""
