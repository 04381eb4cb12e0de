"""Text-overlap metrics: BLEU and ROUGE-L (PyTorch port: a copy of
`diffusion_models_moe_tpu/benchmarks/text_metrics.py`, pure Python).

Completes the reference's prompt-similarity benchmark battery
(reference: benchmarks/prompt_similarity.py / prompt_similarity_artists.py use BLEU
and ROUGE alongside CLIP-text detection accuracy). Pure-python implementations of
corpus BLEU (uniform n-gram weights, brevity penalty) and ROUGE-L F1.
"""
from __future__ import annotations

import collections
import math
from typing import Sequence


def _ngrams(tokens: Sequence[str], n: int):
    return collections.Counter(
        tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def sentence_bleu(reference: str, hypothesis: str, max_n: int = 4) -> float:
    """BLEU with uniform weights over 1..max_n grams + brevity penalty."""
    ref = reference.lower().split()
    hyp = hypothesis.lower().split()
    if not hyp:
        return 0.0
    log_precisions = []
    for n in range(1, max_n + 1):
        ref_counts = _ngrams(ref, n)
        hyp_counts = _ngrams(hyp, n)
        total = sum(hyp_counts.values())
        if total == 0:
            log_precisions.append(float("-inf"))
            continue
        clipped = sum(min(c, ref_counts[g]) for g, c in hyp_counts.items())
        # add-one smoothing above unigrams (standard smoothing-1)
        if clipped == 0 and n > 1:
            clipped, total = 1, total + 1
        if clipped == 0:
            return 0.0
        log_precisions.append(math.log(clipped / total))
    score = math.exp(sum(log_precisions) / max_n)
    bp = 1.0 if len(hyp) >= len(ref) else math.exp(1 - len(ref) / len(hyp))
    return bp * score


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(reference: str, hypothesis: str) -> float:
    """ROUGE-L F1 via longest common subsequence."""
    ref = reference.lower().split()
    hyp = hypothesis.lower().split()
    if not ref or not hyp:
        return 0.0
    lcs = _lcs_len(ref, hyp)
    if lcs == 0:
        return 0.0
    p, r = lcs / len(hyp), lcs / len(ref)
    return 2 * p * r / (p + r)


def corpus_scores(references: Sequence[str], hypotheses: Sequence[str]) -> dict:
    bleus = [sentence_bleu(r, h) for r, h in zip(references, hypotheses)]
    rouges = [rouge_l(r, h) for r, h in zip(references, hypotheses)]
    return {"bleu": sum(bleus) / len(bleus) if bleus else 0.0,
            "rouge_l": sum(rouges) / len(rouges) if rouges else 0.0,
            "n": len(bleus)}
