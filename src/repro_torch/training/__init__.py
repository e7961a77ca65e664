"""Serving steps of the LM stack (prefill, decode, greedy generation)."""
