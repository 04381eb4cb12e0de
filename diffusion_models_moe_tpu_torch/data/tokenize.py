"""The snapshot-less tokenizer of the JAX CLI (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/cli.py:_hash_tokenize`: with no CLIP
tokenizer files at hand, prompts map to md5-seeded token ids, the same in
every process and the same as the JAX CLI's. The analysis flows take
prompt strings through it on seeded random weights.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Sequence

import numpy as np
import torch


def hash_tokenize(vocab: int, maxlen: int
                  ) -> Callable[[Sequence[str]], torch.Tensor]:
    """Returns tokenize(texts) -> (len(texts), maxlen) int64 ids."""
    def tokenize(texts: Sequence[str]) -> torch.Tensor:
        digest = hashlib.md5("\x00".join(texts).encode()).digest()
        rng = np.random.RandomState(
            int.from_bytes(digest[:4], "little") % (2 ** 31))
        ids = rng.randint(0, vocab, (len(texts), maxlen))
        return torch.from_numpy(ids.astype(np.int64))
    return tokenize


def per_prompt_hash_tokenize(vocab: int, maxlen: int
                             ) -> Callable[[Sequence[str]], torch.Tensor]:
    """`hash_tokenize` applied to each prompt alone: a prompt's ids do not
    depend on what it is batched with, as a serving engine needs (the batch
    hash above makes them depend on the whole list)."""
    one = hash_tokenize(vocab, maxlen)

    def tokenize(texts: Sequence[str]) -> torch.Tensor:
        return torch.cat([one([t]) for t in texts])
    return tokenize
