"""The cell-pair interaction engine: tile gather, CUDA kernel, scatter."""
