"""Plotting helpers for analysis artifacts (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/analysis/plots.py`: expert
selection frequency, sparsity and threshold-sweep figures, image grids, and
the census of UNet parameters by kind. Every function takes artifact dicts
or arrays and writes a PNG; matplotlib (and PIL for the grid) is imported
when a figure is drawn, so the module imports where neither is installed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_expert_frequency(freq: dict, out_path: str,
                          timestep: Optional[int] = None) -> None:
    """{layer: (T, E) selection frequency} -> heat/bar figure per layer
    (reference: moefication/plot_freq_counter.py)."""
    plt = _plt()
    layers = sorted(int(l) for l in freq)
    fig, axes = plt.subplots(4, 4, figsize=(16, 10))
    for ax, l in zip(axes.ravel(), layers):
        arr = np.asarray(freq[l] if l in freq else freq[str(l)])
        if timestep is None:
            ax.imshow(arr, aspect="auto", cmap="viridis")
            ax.set_ylabel("t")
        else:
            ax.bar(np.arange(arr.shape[-1]), arr[timestep])
        ax.set_title(f"layer {l}", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_sparsity(sparsity: dict, out_path: str) -> None:
    """{layer: (T,) zero fraction} -> per-layer curves over timesteps
    (reference: sparsity/plot_sparsity.py)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for l in sorted(sparsity, key=int):
        ax.plot(np.asarray(sparsity[l]), label=f"L{l}", alpha=0.7)
    ax.set_xlabel("denoise step")
    ax.set_ylabel("fraction of exact zeros")
    ax.legend(ncol=4, fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_metric_vs_threshold(results: Sequence[tuple], out_path: str,
                             xlabel: str = "confidence",
                             ylabel: str = "metric") -> None:
    """[(threshold, value), ...] sweep curves (the FID-vs-conf / CLIP-vs-conf
    notebook plots)."""
    plt = _plt()
    xs, ys = zip(*sorted(results))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(xs, ys, marker="o")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_metric_vs_confidence(per_concept: dict, out_path: str,
                              ylabel: str = "score",
                              title: str = "") -> None:
    """Multi-panel confidence-sweep plot (reference: notebooks/plot_fid_conf.py
    and plot_conf_val_scores.py — FID / LLaVA style score after removal vs
    t-test confidence). `per_concept` maps concept -> [(conf, value), ...];
    the x axis is the reference's `100 * (1 - conf/2)` percent transform."""
    plt = _plt()
    concepts = list(per_concept)
    fig, axes = plt.subplots(1, len(concepts),
                             figsize=(5 * len(concepts), 5), squeeze=False)
    if title:
        fig.suptitle(title)
    for ax, c in zip(axes[0], concepts):
        confs, ys = zip(*sorted(per_concept[c]))
        xs = [100.0 * (1.0 - v / 2.0) for v in confs]
        ax.plot(xs, ys)
        ax.scatter(xs, ys, marker="o", color="red")
        ax.set_xlabel("Confidence interval (%)")
        ax.set_ylabel(ylabel)
        ax.set_title(str(c))
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def average_results(results: Sequence[dict], floor: float = 0.45,
                    floor_to: float = 1.0) -> dict:
    """Per-key mean over a results.json list, carrying the reference's
    clamp quirk verbatim: values <= `floor` are replaced by `floor_to`
    before averaging (reference: benchmarking results/union-timesteps/
    test_professions/calc_average.py — `result[key] if result[key] > 0.45
    else 1`)."""
    if not results:
        return {}
    return {key: float(np.mean([r[key] if r[key] > floor else floor_to
                                for r in results]))
            for key in results[0]}


def image_grid(images: Sequence, out_path: str, n_cols: int = 5) -> None:
    """Stitch images (H, W, 3) uint8/float arrays into one grid PNG — the
    reference's memorization comparison grids (notebooks/make_mem_grid.py).
    Row-major fill; short final rows pad with black."""
    from PIL import Image

    if not len(images):
        raise ValueError("image_grid needs at least one image")
    arrs = []
    for im in images:
        a = np.asarray(im)
        if a.dtype != np.uint8:
            a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
        if a.ndim == 2:                       # grayscale -> RGB
            a = np.stack([a] * 3, axis=-1)
        elif a.shape[-1] == 4:                # drop alpha
            a = a[..., :3]
        elif a.shape[-1] != 3:
            raise ValueError(f"expected (H, W[, 3|4]) image, got {a.shape}")
        arrs.append(a)
    # slot size fits the largest image; smaller ones sit top-left on black
    h = max(a.shape[0] for a in arrs)
    w = max(a.shape[1] for a in arrs)
    n_rows = (len(arrs) + n_cols - 1) // n_cols
    canvas = np.zeros((n_rows * h, n_cols * w, 3), np.uint8)
    for i, a in enumerate(arrs):
        r, c = divmod(i, n_cols)
        canvas[r * h:r * h + a.shape[0], c * w:c * w + a.shape[1]] = a
    Image.fromarray(canvas).save(out_path)


def unet_parameter_census(unet_state: dict) -> dict:
    """Share of the UNet's parameters in FF blocks, in the attention blocks
    (everything else inside a Transformer2D), in resnets and convs, and the
    rest (time embedding), from the port's state dict."""
    groups = {"ff": 0, "attention": 0, "conv_resnet": 0, "other": 0}
    total = 0
    for key, t in unet_state.items():
        n = t.numel()
        total += n
        if ".ff." in key:
            groups["ff"] += n
        elif ".attentions." in key:
            groups["attention"] += n
        elif "resnets" in key or "conv" in key or "samplers" in key:
            groups["conv_resnet"] += n
        else:
            groups["other"] += n
    return {"total": total,
            **{k: {"params": v, "share": v / total} for k, v in groups.items()}}
