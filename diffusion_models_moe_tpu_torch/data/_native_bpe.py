"""ctypes bridge to the native BPE merge core (`native/bpe_core.cpp`)
(PyTorch port).

Counterpart of `diffusion_models_moe_tpu/data/_native_bpe.py`, on the same
C++ source. The port builds its own copy at first use, into the git-ignored
`ops/_build/` (`ops/_build.load_host_library`). The tokenizer takes the
pure-Python merge loop where this cannot be built.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

from diffusion_models_moe_tpu_torch.ops import _build


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load_host_library("bpe_core")
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.bpe_encode_word.restype = ctypes.c_int
    lib.bpe_encode_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_int]
    lib.bpe_destroy.restype = None
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeBPE:
    """Word -> token ids through the native merge core.

    encoder: token string -> id; the ids must be dense from 0 (true of CLIP
    vocabularies), else ValueError. merges: (left, right) pairs in rank
    order."""

    def __init__(self, encoder: dict[str, int],
                 merges: Sequence[tuple[str, str]]):
        n = max(encoder.values()) + 1 if encoder else 0
        if len(encoder) != n:
            raise ValueError("non-dense vocab ids; native BPE unsupported")
        tokens: list[str] = [""] * n
        for tok, i in encoder.items():
            if "\n" in tok:
                raise ValueError("newline in vocab token")
            tokens[i] = tok
        self._lib = _lib()
        self._h = self._lib.bpe_create(
            "\n".join(tokens).encode("utf-8"),
            "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8"))
        self._buf = (ctypes.c_int32 * 256)()

    def encode_word(self, word: str) -> list[int]:
        """`word` is the byte-unicode form WITHOUT the </w> suffix."""
        raw = word.encode("utf-8")
        n = self._lib.bpe_encode_word(self._h, raw, self._buf, len(self._buf))
        if n >= 0:
            return list(self._buf[:n])
        big = (ctypes.c_int32 * (len(word) * 4 + 8))()   # longer than 256 ids
        n = self._lib.bpe_encode_word(self._h, raw, big, len(big))
        return list(big[:max(n, 0)])

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.bpe_destroy(h)
