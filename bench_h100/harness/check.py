"""The comparison that decides `correct`.

Once the window has closed and the program is freed, the reference
(float32, TF32 off) is built on the device, given the weights made again
from the seed, the same expert labels, token ids and initial noise, and
run over a sample of the requests that the window completed, a few at a
time. Where the cell asks for it, the reference runs a second time under
bfloat16 autocast: the floor, the distance that bfloat16 rounding alone
puts between two runs of this model on these inputs. The numbers a cell
can compare (`numbers`): `px_off_share`, the share of the sampled images'
pixel values more than `px_off` (in [0, 1] units) from the reference's;
`px_off_floor_share`, the share more than `floor_k` times the floor's
root-mean-square distance of their image; `img_rel_l2`, the largest
relative L2 distance ||served - reference|| / ||reference||. Each image's
relative L2 is reported beside them; the cell's numbers and limits are in
`workloads/<cell>.json`.
"""
from __future__ import annotations

import math

import torch

from bench_h100.harness import weights


def rel_l2(served: torch.Tensor, ref: torch.Tensor) -> float:
    served, ref = served.double(), ref.double()
    return float((served - ref).norm() / ref.norm().clamp_min(1e-30))


def reference_images(cell, inputs, sample, steps: int, guidance: float,
                     device, chunk: int, floor: bool) -> tuple:
    """The reference's images (N, 3, H, W) of the sampled requests, and
    with `floor` those of its bfloat16 run (else None)."""
    fam, cfg = cell.family, cell.config
    ref = fam.reference(cfg, device)
    sds = weights.make(fam.skeleton(cfg), inputs.seed, device,
                       norms=fam.NORMS)
    ref.load(sds)
    del sds
    ref.set_routing(inputs.labels(), cfg["moe"]["topk_ratio"])
    out = {False: [], True: []}
    for at in range(0, len(sample), chunk):
        part = sample[at:at + chunk]
        cond, uncond = inputs.ids([r.index for r in part])
        z = inputs.noise([r.seed for r in part], device)
        for bf16 in (False, True) if floor else (False,):
            out[bf16].append(ref.generate(cond, uncond, z, steps, guidance,
                                          bf16=bf16).cpu())
    del ref
    return torch.cat(out[False]), torch.cat(out[True]) if floor else None


def px_off_share(served: torch.Tensor, ref: torch.Tensor, off: float
                 ) -> float:
    """Share of the pixel values that lie more than `off` from the
    reference's, over every sampled image together."""
    return float(((served.double() - ref.double()).abs() > off).double().mean())


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).pow(2).mean().sqrt())


def px_off_floor_share(served, ref, floor, k: float) -> float:
    """Share of the pixel values more than k times the floor's RMS
    distance of their image from the reference's, over every sampled
    image together."""
    off = [(s.double() - r.double()).abs() > k * _rms(f, r)
           for s, r, f in zip(served, ref, floor)]
    return float(torch.stack(off).double().mean())


def numbers(served: torch.Tensor, ref: torch.Tensor, floor, check: dict
            ) -> tuple:
    """(the compared numbers of a cell, named as in its `limits`; each
    image's relative L2). A limit on a number this module does not compute
    is refused: it would hold nothing."""
    per = [rel_l2(s, r) for s, r in zip(served, ref)]
    out = {"img_rel_l2": max(per)}
    if "px_off" in check:
        out["px_off_share"] = px_off_share(served, ref, check["px_off"])
    if "floor_k" in check:
        out["px_off_floor_share"] = px_off_floor_share(served, ref, floor,
                                                       check["floor_k"])
    unknown = set(check["limits"]) - set(out)
    if unknown or not check["limits"]:
        raise ValueError(f"limits on no number computed: {sorted(unknown)}")
    return {k: v for k, v in out.items() if k in check["limits"]}, per


OFFS = (0.03, 0.04, 0.05, 0.06, 0.08, 0.1, 0.15)
FLOOR_KS = (2, 3, 4, 5, 6, 8)


def candidates(served: torch.Tensor, ref: torch.Tensor, floor) -> dict:
    """Numbers a cell could compare, for setting its limits."""
    per = [rel_l2(s, r) for s, r in zip(served, ref)]
    out = {"rel_l2_max": max(per), "rel_l2_mean": sum(per) / len(per)}
    for off in OFFS:
        share = [px_off_share(s, r, off) for s, r in zip(served, ref)]
        out[f"off{off}_pooled"] = sum(share) / len(share)
        out[f"off{off}_max"] = max(share)
    if floor is not None:
        fl = [rel_l2(f, r) for f, r in zip(floor, ref)]
        out["floor_rel_l2_max"] = max(fl)
        out["rel_l2_over_floor_max"] = max(p / max(f, 1e-12)
                                           for p, f in zip(per, fl))
        for off in OFFS:
            out[f"floor_off{off}_pooled"] = px_off_share(floor, ref, off)
        for k in FLOOR_KS:
            out[f"sig{k}_pooled"] = px_off_floor_share(served, ref, floor, k)
            out[f"floor_sig{k}_pooled"] = px_off_floor_share(floor, ref,
                                                             floor, k)
    return out


def compare(cell, inputs, sample, steps: int, guidance: float, device,
            keep: bool = False) -> tuple:
    """({name: {"value", "limit"}}: each number the cell compares beside
    its limit (`workloads/<cell>.json`), {"img_rel_l2_each": [...], and
    with `keep` "candidates"})."""
    limits = cell.check["limits"]
    if not sample:
        return {k: {"value": math.inf, "limit": v} for k, v in limits.items()}, {}
    ref, floor = reference_images(
        cell, inputs, sample, steps, guidance, device,
        cell.check.get("reference_batch", 2),
        keep or "floor_k" in cell.check)
    served = torch.stack([r.image() for r in sample])
    values, per = numbers(served, ref, floor, cell.check)
    out = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    extra = {"img_rel_l2_each": per}
    if keep:
        extra["candidates"] = candidates(served, ref, floor)
    return out, extra
