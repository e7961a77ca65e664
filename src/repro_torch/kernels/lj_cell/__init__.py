"""Cell-blocked Lennard-Jones forces: thin wrappers over the cell-pair
engine."""
