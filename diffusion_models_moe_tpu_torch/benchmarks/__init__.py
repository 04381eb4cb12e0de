"""The judges of the benchmarks (PyTorch port): CLIP metrics and CLIP-IQA,
FID, LPIPS and SSCD scores, text-overlap metrics."""
