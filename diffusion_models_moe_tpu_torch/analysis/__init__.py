"""Skill attribution on taps (PyTorch port)."""
