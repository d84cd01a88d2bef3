"""--arch qwen2.5-32b: full config + reduced smoke config (port of
``repro.configs.qwen2_5_32b``)."""

from repro_torch.configs.registry import get_config, get_smoke_config

ARCH = "qwen2.5-32b"
CONFIG = get_config(ARCH)
SMOKE = get_smoke_config(ARCH)
