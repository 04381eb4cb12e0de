"""Plain PyTorch references, float32 with TF32 off. They import nothing of
the measured program."""
