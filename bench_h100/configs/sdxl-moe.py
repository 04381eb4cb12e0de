"""Configuration `sdxl-moe`: its sizes are `sdxl-moe.json`; the program is the port's
`sdxl_config(torch.bfloat16)`, checked field by field against that file; the
reference is `reference/sd_ref.py`; operations and bytes are counted from
shapes by `harness/counts.py`; the rest of the configuration-module
interface (`harness/loader.py`) is the SD family's."""
from bench_h100.harness.sd_family import (CONTROLS, NORMS,  # noqa: F401
                                          attn_work, ff_widths, ff_work,
                                          generate_flops, latent_shape,
                                          preset_build, reference, skeleton)

PORT_PRESET = "sdxl_config"
build = preset_build(PORT_PRESET)
