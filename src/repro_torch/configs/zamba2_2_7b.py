"""--arch zamba2-2.7b: full config + reduced smoke config (port of
``repro.configs.zamba2_2_7b``)."""

from repro_torch.configs.registry import get_config, get_smoke_config

ARCH = "zamba2-2.7b"
CONFIG = get_config(ARCH)
SMOKE = get_smoke_config(ARCH)
