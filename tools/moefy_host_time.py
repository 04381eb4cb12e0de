"""Host time of the port's balanced k-means on one seeded gate of each SD1.5
FF width, and of its k-means++ seeding.

    python3 tools/moefy_host_time.py [--device cuda|cpu]

For H = 4C gate rows of width C (C = 320, 640, 1280; 64, 128 and 256
experts of 20), drawn N(0, 1/C) from a seeded generator as the pipeline's
seeded weights are, prints one JSON line with the seconds of:

- `seeding`: the port's k-means++ seeding (row blocks on threads);
- `seeding_serial`: the same seeding as one numpy expression per centre,
  the form of the JAX package (the same bits, checked here);
- `balanced_kmeans`: the whole clustering, `method="sinkhorn"`, its plans
  on `--device`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_models_moe_tpu_torch.moefication import cluster  # noqa: E402


def serial_seeding(x: np.ndarray, k: int, rng) -> np.ndarray:
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), x.dtype)
    centers[0] = x[rng.randint(n)]
    closest = np.full(n, np.inf)
    for c in range(1, k):
        closest = np.minimum(closest,
                             np.sum((x - centers[c - 1]) ** 2, axis=1))
        centers[c] = x[rng.choice(n, p=closest / closest.sum())]
    return centers


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = {"device": args.device, "cpus": os.cpu_count(), "widths": {}}
    for c in (320, 640, 1280):
        h, k = 4 * c, 4 * c // 20
        gate = np.random.RandomState(c).randn(h, c) * c ** -0.5
        x = cluster._normalize_rows(gate)
        t0 = time.perf_counter()
        threaded = cluster._kmeanspp_init(x, k, np.random.RandomState(0))
        t1 = time.perf_counter()
        serial = serial_seeding(x, k, np.random.RandomState(0))
        t2 = time.perf_counter()
        if not np.array_equal(threaded, serial):
            raise SystemExit(f"C={c}: threaded seeding differs from serial")
        cluster.balanced_kmeans(gate, k, device=args.device)
        t3 = time.perf_counter()
        out["widths"][c] = {"rows": h, "experts": k, "seeding": t1 - t0,
                            "seeding_serial": t2 - t1,
                            "balanced_kmeans": t3 - t2}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
