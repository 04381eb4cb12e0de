"""The benchmark of the PyTorch port on one NVIDIA H100 (`run.py`)."""
