"""Configuration `sdxl-moe`: its sizes are `sdxl-moe.json`; the program is the port's
`sdxl_config(torch.bfloat16)`, checked field by field against that file; the
reference is `reference/sd_ref.py`; operations and bytes are counted from
shapes by `harness/counts.py`."""
from bench_h100.harness.sd_family import (generate_flops, preset_build,  # noqa: F401
                                          reference, skeleton)

PORT_PRESET = "sdxl_config"
build = preset_build(PORT_PRESET)
