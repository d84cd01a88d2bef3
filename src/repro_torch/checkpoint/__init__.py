"""Checkpoints of a train state (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpointer import LAYOUT_VERSION, Checkpointer, migrate_layout

__all__ = ["LAYOUT_VERSION", "Checkpointer", "migrate_layout"]
