"""--arch hubert-xlarge: full config + reduced smoke config (port of
``repro.configs.hubert_xlarge``)."""

from repro_torch.configs.registry import get_config, get_smoke_config

ARCH = "hubert-xlarge"
CONFIG = get_config(ARCH)
SMOKE = get_smoke_config(ARCH)
