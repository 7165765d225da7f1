"""Synthetic LM token data (a numpy-only copy of ``repro.data``)."""
