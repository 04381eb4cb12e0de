"""Noise schedulers (PNDM, the SD1.x default)."""
