"""The reference's per-concept operating points, consolidated as data
(PyTorch port; a copy of `diffusion_models_moe_tpu/data/operating_points.py`).

The reference hardcodes its known-good thresholds in per-script dicts
(SURVEY.md §5.6 flags this and asks the rebuild to carry them as data):
the Wanda skill ratio used to SELECT neurons for a concept, the
union-over-timesteps ratio its shipped BAKED checkpoints were built with,
and the memorized-trigger prompt per memorization split. A user switching
from the reference needs these numbers to land on the same operating
points, so they are carried verbatim with one table per source:

  WANDA_SKILL_RATIOS_BAKE   <- benchmarks/save_union_over_time.py:9-69
                               (also benchmarks/save_union_experts.py — the
                               mask-selection ratio fed to the baking flow)
  WANDA_SKILL_RATIOS_EVAL   <- benchmarks/eval_coco.py:36-61 (the live
                               WandaRemoveNeuronsFast eval flow; same table
                               in benchmarks/unified_editing.py:19-45)
  UNION_SELECT_RATIOS       <- benchmarks/object_erase.py:33-45
                               (select_ratios — union-over-time ratio used
                               when re-deriving an object checkpoint)
  BAKED_CHECKPOINT_RATIOS   <- ratios parsed from the shipped checkpoint
                               filenames: benchmarks/object_erase.py:22-32
                               (checkpoints_dict, '<concept>_<ratio>.pt') and
                               benchmarks/eval_coco.py:62-69 /
                               artist_removal.py:25-32 (best_ckpt_dict)
  MEMORIZED_TRIGGER_PROMPTS <- benchmarks/save_union_over_ap.py:24-45
                               (test_prompts — the memorized LAION trigger
                               caption per memorize_{i} split)
  UCE_MODEL_FILES           <- benchmarks/eval_coco.py:70-81 /
                               artist_removal.py:34-45 (uce_models_dict —
                               filenames of the external UCE baseline
                               checkpoints those protocols compare against)

Reference quirks carried on purpose (documented, not "fixed"):
  - the bake table holds BOTH 'Parachute': 0.005 and 'parachute': 0.02 —
    the reference's lookups are case-sensitive, so which value applies
    depends on the caller's capitalization; `wanda_skill_ratio` resolves
    exact-case first and falls back to lowercase, reproducing that behavior
    for both spellings;
  - eval_coco's '5artists_naked' entry is the empty string (the script
    builds a path with it and relies on the multi-concept flow instead);
    it is carried as None here;
  - the eval table and the bake table genuinely disagree for some concepts
    (e.g. '5artists': 0.95 eval vs 0.9 bake, 'Monet': 0.05 eval vs 0.02
    bake) — they are different flows in the reference, not a typo.
"""
from __future__ import annotations

from typing import Mapping, Optional

WANDA_SKILL_RATIOS_BAKE: dict[str, float] = {
    "5artists": 0.9,
    "10artists": 0.85,
    "50artists": 0.02,
    "5artists_removal": 0.02,
    "naked": 0.01,
    "Van Gogh": 0.02,
    "Monet": 0.02,
    "Pablo Picasso": 0.02,
    "Salvador Dali": 0.02,
    "Leonardo Da Vinci": 0.02,
    "Rembrandt": 0.02,
    "Cassette Player": 0.01,
    "gender": 0.05,
    "gender_female": 0.05,
    "garbage truck": 0.005,
    "english springer": 0.005,
    "chain saw": 0.005,
    "church": 0.02,
    "tench": 0.005,
    "golf ball": 0.005,
    "Parachute": 0.005,
    "french horn": 0.005,
    "Gas Pump": 0.005,
    "parachute": 0.02,
    "cassette player": 0.005,
    "gas pump": 0.005,
    # memorize + memorize_{0..19} all use 0.01 (save_union_over_time.py:23-44)
    "memorize": 0.01,
    **{f"memorize_{i}": 0.01 for i in range(20)},
}

WANDA_SKILL_RATIOS_EVAL: dict[str, Optional[float]] = {
    "Alex Alemany,painter": 0.05,
    "John Howe,illustrator": 0.05,
    "Antonio J. Manzanedo": 0.05,
    "Alpo Jaakola,painter": 0.05,
    "Abraham Mintchine,painter": 0.05,
    "Apollinary Vasnetsov,landscape art,history painting": 0.05,
    "John Constable,realism,landscape art": 0.05,
    "Johannes Vermeer,genre painting,portrait": 0.05,
    "Nicolas Mignard,mythological painting,painter": 0.05,
    "John Whitcomb": 0.05,
    "Amedeo Modigliani,landscape art,portrait": 0.05,
    "Jordan Grimmer": 0.05,
    "A.J.Casson": 0.05,
    "Akira Toriyama,mangaka,fantasy": 0.05,
    "Salvador Dali": 0.05,
    "Greg Rutkowski": 0.05,
    "Jeremy Mann": 0.05,
    "Van Gogh": 0.02,
    "Monet": 0.05,
    "Pablo Picasso": 0.05,
    "naked": 0.01,
    "memorize": 0.01,
    "5artists_naked": None,            # '' in the reference (path quirk)
    "5artists": 0.95,
    "10artists": 0.95,
    "Juliana Huxtable,Valerie Hegarty,Wendy Froud,Kobayashi Kiyochika,"
    "Paul Laffoley": 0.02,
}

UNION_SELECT_RATIOS: dict[str, Optional[float]] = {
    "golf ball": 0.4,
    "english springer": 0.6,
    "garbage truck": 0.0,
    "chain saw": 0.0,
    "tench": 0.3,
    "french horn": 0.0,
    "parachute": 0.0,
    "gas pump": 0.0,
    "cassette player": 0.0,
    "church": 0.0,
    "all_imagenette_objects": None,    # '' in the reference
}

BAKED_CHECKPOINT_RATIOS: dict[str, float] = {
    # object_erase.py:22-32 checkpoints_dict ('<concept>_<ratio>.pt')
    "Church": 0.4,
    "Golf Ball": 0.3,
    "English Springer": 0.4,
    "Garbage Truck": 0.4,
    "Chain Saw": 0.2,
    "Tench": 0.4,
    "French Horn": 0.2,
    "Parachute": 0.2,
    "Gas Pump": 0.2,
    "Cassette Player": 0.0,
    # eval_coco.py:62-69 / artist_removal.py:25-32 best_ckpt_dict
    # (eval_coco ships Salvador Dali at 0.4; artist_removal at 0.0 — both
    # kept, artist flow wins the plain key, eval flow under the * key)
    "Van Gogh": 0.0,
    "Monet": 0.0,
    "Pablo Picasso": 0.0,
    "Salvador Dali": 0.0,
    "Salvador Dali (eval_coco)": 0.4,
    "Leonardo Da Vinci": 0.0,
}

MEMORIZED_TRIGGER_PROMPTS: dict[str, str] = {
    "memorize": "Ann Graham Lotz",
    "memorize_0": "Ann Graham Lotz",
    **{f"memorize_{i}": "The No Limits Business Woman Podcast"
       for i in range(1, 20)},
}

UCE_MODEL_FILES: dict[str, str] = {
    "50artists": "erased-50artists-towards_art-preserve_true-sd_1_4"
                 "-method_replace.pt",
    "1artist": "erased-algernon blackwood-towards_art-preserve_true-sd_1_4"
               "-method_replace.pt",
    "10artists": "erased-asger jorn_eric fischl_johannes vermeer_apollinary "
                 "vasnetsov_naoki urasawa_nicolas mignard_john whitcomb_john "
                 "constable_warwick globe_albert marquet-towards_art-"
                 "preserve_true-sd_1_4-method_replace.pt",
    "5artists": "erased-juliana huxtable_valerie hegarty_wendy froud_"
                "kobayashi kiyochika_paul laffoley-towards_art-preserve_true"
                "-sd_1_4-method_replace.pt",
    "100artists": "erased-100artists-towards_art-preserve_true-sd_1_4"
                  "-method_replace.pt",
    "Van Gogh": "erased-van gogh-towards_art-preserve_true-sd_1_4"
                "-method_replace.pt",
    "Monet": "erased-claude monet-towards_art-preserve_true-sd_1_4"
             "-method_replace.pt",
    "Pablo Picasso": "erased-pablo picasso-towards_art-preserve_true-sd_1_4"
                     "-method_replace.pt",
    "Salvador Dali": "erased-salvador dali-towards_art-preserve_true-sd_1_4"
                     "-method_replace.pt",
    "Leonardo Da Vinci": "erased-leonardo da vinci-towards_art-preserve_true"
                         "-sd_1_4-method_replace.pt",
}


def _lookup(table: Mapping[str, Optional[float]], concept: str):
    if concept in table:
        return table[concept]
    low = concept.strip().lower()
    for key, val in table.items():
        if key.lower() == low:
            return val
    return None


def wanda_skill_ratio(concept: str, flow: str = "bake",
                      default: Optional[float] = None) -> Optional[float]:
    """Known-good Wanda skill ratio for `concept` — exact-case match first
    (the reference's dict lookups are case-sensitive and the bake table has
    case-differing duplicates), then case-insensitive, then `default`.
    `flow` is 'bake' (save_union_over_time) or 'eval' (eval_coco live
    removal)."""
    if flow not in ("bake", "eval"):
        raise ValueError(f"flow must be bake|eval, got {flow!r}")
    table = (WANDA_SKILL_RATIOS_BAKE if flow == "bake"
             else WANDA_SKILL_RATIOS_EVAL)
    val = _lookup(table, concept)
    return default if val is None else val


def union_select_ratio(concept: str,
                       default: Optional[float] = None) -> Optional[float]:
    """Union-over-timesteps ratio the reference re-derives an object
    checkpoint with (object_erase.py select_ratios)."""
    val = _lookup(UNION_SELECT_RATIOS, concept)
    return default if val is None else val


def baked_checkpoint_ratio(concept: str,
                           default: Optional[float] = None) -> Optional[float]:
    """Ratio baked into the reference's shipped '<concept>_<ratio>.pt'
    checkpoints (its best operating point per concept)."""
    val = _lookup(BAKED_CHECKPOINT_RATIOS, concept)
    return default if val is None else val
