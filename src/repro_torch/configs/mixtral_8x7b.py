"""--arch mixtral-8x7b: full config + reduced smoke config (port of
``repro.configs.mixtral_8x7b``)."""

from repro_torch.configs.registry import get_config, get_smoke_config

ARCH = "mixtral-8x7b"
CONFIG = get_config(ARCH)
SMOKE = get_smoke_config(ARCH)
