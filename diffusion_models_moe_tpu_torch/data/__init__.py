"""Prompt data helpers (PyTorch port)."""
