"""Pytree checkpoints in the reference's file format (port of
``repro.checkpoint``)."""
from .ckpt import latest_step, restore, save, save_step

__all__ = ["latest_step", "restore", "save", "save_step"]
