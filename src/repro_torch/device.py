"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when a CUDA device is
    asked for and none is available (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def rank_device(local_rank: int, device: str | torch.device = "cuda", *,
                local_world: int = 1) -> torch.device:
    """The device of a world's rank: ``cuda:local_rank``, one card a rank
    (NCCL puts no two ranks of a communicator on one card), or the CPU for
    ``device="cpu"``.  Raises when the host's ranks (``local_world``)
    outnumber its cards; never falls back to the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    cards = torch.cuda.device_count()
    if max(local_world, local_rank + 1) > cards:
        raise RuntimeError(f"{local_world} ranks on this host but torch sees {cards} CUDA "
                           f"device(s): a world needs one card a rank")
    return torch.device("cuda", local_rank)
