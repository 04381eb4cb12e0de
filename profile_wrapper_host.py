"""Host time of the MoE wrappers: what a call of the fused FF (kernel 1,
`geglu_ff_fused`) and of the routing kernel (kernel 4,
`fused_route_multiply`) costs the host before it returns, with the kernels
still running.

The serving path is host-bound, so this time, not the kernels' device time,
is what a generate's wall feels. For each kernel the 16 FFs of one SD1.5
UNet call at batch 4 (CFG on 2 requests) are made, each with its own seeded
tensors (5, 5, 5 and 1 FFs at the four levels, as the UNet hands them over:
its tensor maps cannot all be the ones of the call before), and the
wrapper is called on them in turn; then on the first FF's tensors again and
again. Each round of 16 calls is timed apart, after the card has finished
the round before, so the launch queue never fills and the time is the
host's alone; the median round is reported, since the host's clock spreads
(a one-card machine shares its host's cores). Needs one CUDA card:

    python3 profile_wrapper_host.py

The last line is one JSON object with every number printed.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

LEVELS = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))   # tokens, C
LEVEL_BLOCKS = (5, 5, 5, 1)
BATCH = 4           # UNet batch: CFG on 2 requests
ROUNDS = 15         # timed rounds of the 16 calls


def ff_inputs(seed: int, tokens: int, c: int) -> tuple:
    """One FF's seeded inputs: (x, w1, b1, w2, b2, patterns, k, ln)."""
    from diffusion_models_moe_tpu_torch.taps import patterns_from_labels
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, hdim = BATCH * tokens, 4 * c
    e = hdim // 20

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    lab = np.random.RandomState(seed).permutation(np.arange(hdim) % e)
    pat = patterns_from_labels(lab, e).to("cuda", torch.bfloat16)
    ln = dict(ln_scale=rn(c, scale=0.1, dtype=torch.float32) + 1.0,
              ln_bias=rn(c, scale=0.1, dtype=torch.float32))
    return (rn(n, c), rn(2 * hdim, c, scale=c ** -0.5), rn(2 * hdim, scale=0.1),
            rn(c, hdim, scale=hdim ** -0.5), rn(c, scale=0.1), pat,
            max(int(e * 0.3), 1), ln)


def host_us(calls: list) -> float:
    """Host microseconds a call takes to return: the median over ROUNDS
    rounds of `calls`, each timed alone after one untimed round."""
    for fn in calls:
        fn()
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fn in calls:
            fn()
        rounds.append((time.perf_counter() - t0) / len(calls) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(rounds))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_wrapper_host: no CUDA device")
    from diffusion_models_moe_tpu_torch.ops.geglu_ff_fused import geglu_ff_fused
    from diffusion_models_moe_tpu_torch.ops.routing_kernel import (
        fused_route_multiply)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    ff_calls, route_calls = [], []
    seed = 0
    for (tokens, c), count in zip(LEVELS, LEVEL_BLOCKS):
        for _ in range(count):
            x, w1, b1, w2, b2, pat, k, ln = ff_inputs(seed, tokens, c)
            seed += 1
            ff_calls.append(lambda a=(x, w1, b1, w2, b2, pat, k), kw=ln:
                            geglu_ff_fused(*a, **kw))
            # hidden in place as the first half of the (N, 2H) projection,
            # the gate beside it, as the unfused FF hands them over
            proj = x @ w1.t()
            hdim = w1.shape[0] // 2
            hidden = proj[:, :hdim]
            gate = torch.nn.functional.gelu(proj[:, hdim:])
            route_calls.append(lambda a=(hidden, gate, pat, k):
                               fused_route_multiply(*a))
    out = {}
    for name, calls in (("geglu_ff_fused", ff_calls),
                        ("fused_route_multiply", route_calls)):
        cycle = host_us(calls)
        same = host_us([calls[0]] * len(calls))
        out[name] = dict(host_us_16_ffs_in_turn=cycle, host_us_one_ff=same)
        print(f"{name}: host {cycle:.1f} us a call over the 16 FFs of a UNet "
              f"call in turn, {same:.1f} us a call on one FF's tensors "
              f"(median of {ROUNDS} rounds of {len(calls)} calls)",
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "host": out}))


if __name__ == "__main__":
    main()
