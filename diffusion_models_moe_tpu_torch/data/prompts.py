"""Concept prompt-pair construction for skill attribution (PyTorch port).

Counterpart of `diffusion_models_moe_tpu/data/prompts.py`: for each concept
class, how the neutral base prompt and the concept-bearing prompt are formed
from a subject list, and the curated prompt and subject files the protocols
read. Those files are a byte-identical copy of the JAX package's
`data/datasets/`, kept in this package's `data/datasets/` so that the port
reads no file of the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence

# the curated concept and prompt files (memorised LAION captions, I2P prompt
# dumps, artist lists, professions, validation subjects): data, copied
# verbatim; they define the protocols' operating points
DATASETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "datasets")


def dataset_path(name: str) -> str:
    return os.path.join(DATASETS_DIR, name)


def has_dataset(name: str) -> bool:
    return os.path.exists(dataset_path(name))


@functools.lru_cache(maxsize=128)
def load_dataset_file(name: str) -> tuple[str, ...]:
    """Non-empty stripped lines of a shipped dataset file."""
    with open(dataset_path(name)) as f:
        return tuple(line.strip() for line in f if line.strip())


def memorized_captions(split: int | str = "") -> list[str]:
    """Memorized LAION captions — the memorization protocol's input
    (reference: benchmarks/inference_mem.py, modularity/datasets/memorize_*.txt).
    `split` in 0..19 picks one 25-caption chunk; '' loads the 500-caption file."""
    name = f"memorize_{split}.txt" if split != "" else "memorize.txt"
    return list(load_dataset_file(name))


def non_memorized_captions() -> list[str]:
    """Control captions labeled 0 in the AP selector (reference:
    modularity/skilled_neuron_ap.py non_mem.txt)."""
    return list(load_dataset_file("non_mem.txt"))


def i2p_prompts(variant: str = "") -> list[str]:
    """I2P NSFW eval prompts (reference: benchmarks/i2p_eval.py,
    modularity/datasets/i2p_prompts_seed_0*.txt)."""
    name = f"i2p_prompts_seed_0{('_' + variant) if variant else ''}.txt"
    return list(load_dataset_file(name))


def artist_names(n: int = 100, part: int = 1) -> list[str]:
    """Artist lists for the {1,5,10,50,100}-artist removal protocols
    (reference: modularity/datasets/{n}artists*.txt)."""
    if n == 100:
        return list(load_dataset_file(f"100artists_{part}.txt"))
    if n == 1:
        return list(load_dataset_file("1artist.txt"))
    return list(load_dataset_file(f"{n}artists.txt"))


def professions(gender: Optional[str] = None) -> list[str]:
    """Profession lists for the gender-debias protocol (reference:
    modularity/datasets/{male,female}_professions.txt, professions.txt)."""
    if gender in ("male", "female"):
        return list(load_dataset_file(f"{gender}_professions.txt"))
    return list(load_dataset_file("professions.txt"))


def erasing_objects() -> list[str]:
    return list(load_dataset_file("erasing_objects.txt"))


def _file_or(name: str, fallback: Sequence[str]) -> list[str]:
    return list(load_dataset_file(name)) if has_dataset(name) else list(fallback)


def combine_prompt_datasets(artwork_csv: str, i2p_file: str,
                            out_csv: str) -> int:
    """Merge an artwork-prompts CSV (case_number, prompt, evaluation_seed,
    artist) with an I2P prompt list into one eval CSV, renaming artist ->
    concept and tagging I2P rows concept='naked'
    (reference: benchmarks/create_datasets.py). Returns the row count."""
    import csv
    with open(artwork_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r["concept"] = r.pop("artist", r.get("concept", ""))
    start = len(rows)
    with open(i2p_file) as f:
        i2p = [line.strip() for line in f if line.strip()]
    for i, prompt in enumerate(i2p):
        rows.append({"case_number": str(start + i), "prompt": prompt,
                     "evaluation_seed": "0", "concept": "naked"})
    fields = ["case_number", "prompt", "evaluation_seed", "concept"]
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)
    return len(rows)


# ---- built-in subject lists (framework data; override with files as needed) ----
THINGS = [
    "cat", "dog", "horse", "bird", "house", "tree", "car", "bicycle", "boat",
    "chair", "table", "flower", "mountain", "river", "bridge", "castle",
    "garden", "street", "beach", "forest",
]
ANIMALS = ["cat", "dog", "horse", "rabbit", "lion", "elephant", "bear",
           "tiger", "deer", "fox"]
HUMANS_MALE = ["man", "boy", "male person", "gentleman"]
HUMANS_FEMALE = ["woman", "girl", "female person", "lady"]
PROFESSIONS = ["doctor", "nurse", "teacher", "engineer", "lawyer", "chef",
               "firefighter", "scientist", "pilot", "librarian"]
IMAGENETTE = ["tench", "english springer", "cassette player", "chain saw",
              "church", "french horn", "garbage truck", "gas pump",
              "golf ball", "parachute"]
ARTISTS = ["Van Gogh", "Monet", "Pablo Picasso", "Salvador Dali",
           "Greg Rutkowski", "Jeremy Mann", "Leonardo Da Vinci", "Rembrandt"]

_PREFIX_ADJECTIVES = {"white", "black", "jumping", "running"}
_SUFFIX_POSITIONS = {"under a tree", "on a table", "behind a tree",
                     "on the left of a tree", "near a tree", "in a room",
                     "on the street"}
_TABLE_OBJECTS = {"chain saw", "golf ball", "french horn"}
_ROAD_OBJECTS = {"gas pump", "church", "garbage truck"}


@dataclasses.dataclass(frozen=True)
class PromptPairs:
    base: list[str]
    concept: list[str]
    is_nsfw: bool = False


def load_subjects(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def concept_prompts(concept: str, subjects: Optional[Sequence[str]] = None,
                    captions: Optional[Sequence[str]] = None) -> PromptPairs:
    """Build (base, concept) prompt pairs for a concept.

    Classes (mirroring reference behavior, mod_utils.py:53-176):
      adjectives      -> 'a {thing}' vs 'a {adj} {thing}'
      positions       -> 'a {thing}' vs 'a {thing} {position}'
      'painting'      -> photo-of vs painting-of
      artist styles   -> 'a photo of a {thing}' vs 'a {thing} in the style of X'
      'naked'/'nudity'-> NSFW flag set; naked/sexual/erotic phrasings
      imagenette      -> scene-anchored object prompts
      'memorize*'     -> base '' vs raw memorized captions
      'gender'        -> headshot prompts of professions (pairs identical; the
                         signal is in generations, not prompts)
    """
    low = concept.lower()
    if subjects is not None:
        things = list(subjects)
    else:
        # shipped things.txt is the reference's default subject list
        things = _file_or("things.txt", THINGS)

    if low in _PREFIX_ADJECTIVES:
        return PromptPairs([f"a {t}" for t in things],
                           [f"a {low} {t}" for t in things])
    if low in _SUFFIX_POSITIONS:
        return PromptPairs([f"a {t}" for t in things],
                           [f"a {t} {low}" for t in things])
    if low == "painting":
        return PromptPairs([f"a photo of a {t}" for t in things],
                           [f"a painting of a {t}" for t in things])
    if low == "naked":
        return PromptPairs([f"a photo of a {t}" for t in things],
                           [f"a photo of a naked {t}" for t in things],
                           is_nsfw=True)
    if low == "nudity":
        humans = HUMANS_MALE + HUMANS_FEMALE
        variants = ["naked", "completely naked", "sexual", "erotic"]
        base = [f"a photo of a {h}" for h in humans] * len(variants)
        adj = [f"a photo of a {v} {h}" for v in variants for h in humans]
        return PromptPairs(base, adj, is_nsfw=True)
    if low == "gender":
        if subjects is None:
            subjects = _file_or("professions.txt", PROFESSIONS)
        prompts = [f"a headshot of a {p}" for p in subjects]
        return PromptPairs(prompts, list(prompts))
    if low.startswith("memorize") or low == "violence":
        caps = list(captions) if captions else None
        if caps is None and low == "violence" and has_dataset("violent.txt"):
            caps = list(load_dataset_file("violent.txt"))
        if caps is None and low.startswith("memorize"):
            split = low.removeprefix("memorize").lstrip("_")
            name = f"memorize_{split}.txt" if split else "memorize.txt"
            if has_dataset(name):
                caps = list(load_dataset_file(name))
        caps = caps or []
        return PromptPairs(["" for _ in caps], caps, is_nsfw=(low == "violence"))
    if low in _TABLE_OBJECTS:
        return PromptPairs([f"a photo of a table" for _ in things],
                           [f"a photo of a {low} on the table" for _ in things])
    if low in _ROAD_OBJECTS:
        return PromptPairs([f"a photo of a road" for _ in things],
                           [f"a photo of a {low} on the side of the road"
                            for _ in things])
    if low in (s.lower() for s in IMAGENETTE):
        return PromptPairs([f"a photo of a {t}" for t in things],
                           [f"a photo of a {low}" for _ in things])
    # default: treat the concept as an artistic style
    return PromptPairs([f"a photo of a {t}" for t in things],
                       [f"a {t} in the style of {concept}" for t in things])


def validation_prompts(concept: str, subjects: Optional[Sequence[str]] = None
                       ) -> PromptPairs:
    """Held-out subjects for removal validation (reference:
    modularity/remove_experts.py:160-173 uses val_things_{concept}.txt).

    If the shipped `val_things_{concept}.txt` exists, its lines are used AS the
    validation prompts directly (the reference files contain full prompts, not
    subjects)."""
    if subjects is None and has_dataset(f"val_things_{concept}.txt"):
        val_prompts = list(load_dataset_file(f"val_things_{concept}.txt"))
        return PromptPairs(val_prompts, list(val_prompts))
    val = subjects if subjects is not None else ANIMALS
    return concept_prompts(concept, subjects=val)
