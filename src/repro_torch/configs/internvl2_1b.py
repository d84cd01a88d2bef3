"""--arch internvl2-1b: full config + reduced smoke config (port of
``repro.configs.internvl2_1b``)."""

from repro_torch.configs.registry import get_config, get_smoke_config

ARCH = "internvl2-1b"
CONFIG = get_config(ARCH)
SMOKE = get_smoke_config(ARCH)
