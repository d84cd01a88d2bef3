"""Carry the reference's weights across to the port.

The reference's ``transformer.init_params`` tree (dense family), already
turned into numpy arrays by the caller, maps onto the port's parameter
dict so that both packages compute the same function.  Both keep layers
stacked on a leading ``[L, ...]`` axis, the ``x @ W`` layout of the
attention and SwiGLU matrices, norm weights ``w`` under the ``(1 + w)``
convention, and a tied head read as ``embed.T``; only the nesting
differs (the reference groups ``attn``/``mlp`` sub-dicts per layer).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


def _tensor(x, dtype, device) -> torch.Tensor:
    # through fp32: numpy has no bfloat16, and bf16 -> fp32 -> bf16 is exact
    return torch.from_numpy(np.array(x, np.float32)).to(device=device, dtype=dtype)


def params_from_reference(np_params: Mapping[str, Any], cfg: ModelConfig,
                          device="cuda") -> dict[str, Any]:
    """Reference params (numpy leaves) -> the port's params on ``device``."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    lay = np_params["layers"]
    src = {
        "wq": lay["attn"]["wq"], "wk": lay["attn"]["wk"],
        "wv": lay["attn"]["wv"], "wo": lay["attn"]["wo"],
        "ln1": lay["ln1"], "ln2": lay["ln2"],
        "w1": lay["mlp"]["w1"], "w3": lay["mlp"]["w3"], "w2": lay["mlp"]["w2"],
    }
    for name, leaf in src.items():
        if np.shape(leaf)[0] != cfg.n_layers:
            raise ValueError(f"layer leaf {name}: leading axis {np.shape(leaf)[0]} "
                             f"!= n_layers {cfg.n_layers}")
    out = {
        "embed": _tensor(np_params["embed"], dtype, device),
        "final_norm": _tensor(np_params["final_norm"], dtype, device),
        "layers": {k: _tensor(v, dtype, device) for k, v in src.items()},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(np_params["lm_head"], dtype, device)
    return out
