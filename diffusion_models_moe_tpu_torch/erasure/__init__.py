"""Concept erasure masks and their baking (PyTorch port)."""
