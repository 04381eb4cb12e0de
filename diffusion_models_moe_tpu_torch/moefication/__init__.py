"""MoEfication helpers (PyTorch port)."""
