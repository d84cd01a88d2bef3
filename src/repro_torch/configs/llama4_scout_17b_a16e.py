"""--arch llama4-scout-17b-a16e: full config + reduced smoke config (port of
``repro.configs.llama4_scout_17b_a16e``)."""

from repro_torch.configs.registry import get_config, get_smoke_config

ARCH = "llama4-scout-17b-a16e"
CONFIG = get_config(ARCH)
SMOKE = get_smoke_config(ARCH)
