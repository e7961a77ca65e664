"""The LM stack: transformer layers and the model assembly (dense kind)."""
