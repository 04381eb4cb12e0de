"""Noise schedulers: PNDM (the SD1.x default), DDIM (SD2.x), Euler,
DPM-Solver++ 2M and LCM."""
