"""The inputs of a run, all from `--seed`: prompts and their token ids,
each request's seed and initial noise, and the MoE expert labels.

Token ids come from the hash tokenizer of the port's command line (md5 of
the prompt seeds a numpy draw of ids), copied here so that the benchmark,
not the program, makes them. A request's initial noise is the program's
determinism contract: N(0, 1) of the configuration's latent shape from a
`torch.Generator` on the card seeded with the request's seed alone;
`Inputs.noise` draws it the same way for the reference. What the inputs
need to know of the model (its FF widths, its latent shape) comes from the
configuration's module.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

# the labels' and the request seeds' streams, apart from the weights' (0)
_LABELS, _REQUESTS, _WARMUP = 1, 2, 100


def hash_tokenize(vocab: int, maxlen: int):
    """tokenize(texts) -> (len(texts), maxlen) int64 ids, each prompt's ids
    from that prompt alone."""
    def one(text: str) -> np.ndarray:
        digest = hashlib.md5(text.encode()).digest()
        rng = np.random.RandomState(
            int.from_bytes(digest[:4], "little") % (2 ** 31))
        return rng.randint(0, vocab, (1, maxlen))

    def tokenize(texts: Sequence[str]) -> torch.Tensor:
        return torch.from_numpy(np.concatenate([one(t) for t in texts])
                                .astype(np.int64))
    return tokenize


def stream(seed: int, tag: int) -> np.random.Generator:
    """An independent numpy stream of the run's seed (any size of int)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64,
                                                         tag]))


class Inputs:
    """What the benchmark hands both the program and the reference."""

    def __init__(self, cfg: dict, seed: int, family):
        self.cfg, self.seed, self.family = cfg, int(seed), family
        text = cfg["text_encoders"][0]
        self.tokenize = hash_tokenize(text["vocab_size"], text["max_length"])
        self._seeds = stream(seed, _REQUESTS)
        self._drawn: list = []

    def prompt(self, i: int) -> str:
        return f"request {self.seed} {i}"

    def request_seed(self, i: int) -> int:
        """Request i's seed: the i-th draw of the run's request stream; a
        negative index (a warm-up request) draws from a stream of its own."""
        if i < 0:
            return int(stream(self.seed, _WARMUP - i).integers(0, 2 ** 62))
        while len(self._drawn) <= i:
            self._drawn.extend(self._seeds.integers(0, 2 ** 62, 256).tolist())
        return int(self._drawn[i])

    def ids(self, indices: Sequence[int]) -> tuple:
        """(cond ids, uncond ids), each (B, S): the prompts' and the empty
        prompt's."""
        cond = self.tokenize([self.prompt(i) for i in indices])
        return cond, self.tokenize([""]).repeat(len(indices), 1)

    def labels(self) -> list:
        """Random balanced expert labels of every routed FF, in execution
        order: its hidden width H (the family's `ff_widths`) split into
        experts of `expert_size` neurons."""
        moe, rng = self.cfg["moe"], stream(self.seed, _LABELS)
        return [rng.permutation(np.arange(h) % (h // moe["expert_size"]))
                for h in self.family.ff_widths(self.cfg)]

    def noise(self, seeds: Sequence[int], device) -> torch.Tensor:
        """The requests' N(0, 1) latents (B, C, s, s) at the family's
        `latent_shape`, each from a generator on `device` seeded with that
        request's seed."""
        shape = self.family.latent_shape(self.cfg)
        out = []
        for sd in seeds:
            g = torch.Generator(device=device).manual_seed(int(sd))
            out.append(torch.randn((1, *shape), generator=g, device=device))
        return torch.cat(out)
