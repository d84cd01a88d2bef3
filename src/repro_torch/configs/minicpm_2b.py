"""--arch minicpm-2b: full config + reduced smoke config (port of
``repro.configs.minicpm_2b``)."""

from repro_torch.configs.registry import get_config, get_smoke_config

ARCH = "minicpm-2b"
CONFIG = get_config(ARCH)
SMOKE = get_smoke_config(ARCH)
