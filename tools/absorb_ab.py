"""Kernels 5 and 6 of one checkout of the torch port against another's, and
kernel 1's bits, on one CUDA card.

    python3 tools/absorb_ab.py [--root DIR]

Imports `diffusion_models_moe_tpu_torch` and the timing helpers of
`chip_smoke.py` from DIR (default: this checkout), builds its kernels there,
and prints one JSON line:

- kernels 5 (`ln_qkv_fused`, with the LayerNorm) and 6
  (`attn_out_residual_fused`) at the four SD1.5 self-attention shapes (UNet
  batch 4, 8 heads): device ms from a CUDA graph of 20 calls, ms by CUDA
  events around 20 back-to-back calls, and the host microseconds a call;
- the sha256 of kernel 1's output (`geglu_ff_fused`, routed, with the
  LayerNorm) at the four SD1.5 FF shapes for seed 0, so that two checkouts'
  bits can be compared.

Two checkouts are compared in one call on one card, in turns (A, B, B, A):
the older one unpacked with `git archive` into a git-ignored directory.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

LEVELS = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
BATCH, HEADS = 4, 8


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(parser.parse_args().root)
    if not torch.cuda.is_available():
        raise SystemExit("absorb_ab: needs a CUDA device")
    sys.path.insert(0, root)
    # the checkout's own timing helpers (graph, events, host microseconds)
    from chip_smoke import cuda_ms, graph_ms, host_us
    from diffusion_models_moe_tpu_torch.ops import _build
    from diffusion_models_moe_tpu_torch.ops import attn_absorb_fused as ab
    from diffusion_models_moe_tpu_torch.ops import geglu_ff_fused as ffm
    from diffusion_models_moe_tpu_torch.taps import patterns_from_labels
    lib = _build.load_library()
    if not str(lib.path).startswith(root):
        raise SystemExit(f"absorb_ab: kernels loaded from {lib.path}, not "
                         f"from {root}")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "ln_qkv": [], "attn_out": [], "ff_sha256": []}
    for s, c in LEVELS:
        x = rn(BATCH, s, c)
        wq, wk, wv, wo = (rn(c, c, scale=c ** -0.5) for _ in range(4))
        bo = rn(c, scale=0.1)
        g = rn(c, scale=0.1, dtype=torch.float32) + 1.0
        b = rn(c, scale=0.1, dtype=torch.float32)
        o = rn(BATCH, s, HEADS, c // HEADS)
        for name, fn in (
                ("ln_qkv", lambda: ab.ln_qkv_fused(x, wq, wk, wv, HEADS, g, b)),
                ("attn_out", lambda: ab.attn_out_residual_fused(o, wo, bo, x))):
            out[name].append(dict(shape=f"S={s},C={c}", graph_ms=graph_ms(fn),
                                  events_ms=cuda_ms(fn, 20), host_us=host_us(fn)))
    for tokens, c in LEVELS:
        n, hdim = BATCH * tokens, 4 * c
        e = hdim // 20
        x = rn(n, c)
        w1, b1 = rn(2 * hdim, c, scale=c ** -0.5), rn(2 * hdim, scale=0.1)
        w2, b2 = rn(c, hdim, scale=hdim ** -0.5), rn(c, scale=0.1)
        g = rn(c, scale=0.1, dtype=torch.float32) + 1.0
        b = rn(c, scale=0.1, dtype=torch.float32)
        labels = np.random.RandomState(c).permutation(np.arange(hdim) % e)
        pat = patterns_from_labels(labels, e).to(dev, bf16)
        y = ffm.geglu_ff_fused(x, w1, b1, w2, b2, pat, int(0.3 * e),
                               ln_scale=g, ln_bias=b)
        torch.cuda.synchronize()
        digest = hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes())
        out["ff_sha256"].append(dict(shape=f"N={n},C={c},H={hdim},E={e}",
                                     sha256=digest.hexdigest()))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
