"""Checkpoints in the reference's on-disk format, and ``pack_tree``, the
same container in one buffer (the serving tier's wire form)."""
from repro_torch.checkpoint.checkpoint import (latest_step, load_meta,
                                               pack_tree, peek_meta, restore,
                                               save, unpack_tree)

__all__ = ["latest_step", "load_meta", "pack_tree", "peek_meta", "restore",
           "save", "unpack_tree"]
