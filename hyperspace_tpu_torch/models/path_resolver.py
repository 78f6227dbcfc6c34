"""Resolves the Hyperspace system root and per-index paths.

The system path comes from conf ``hyperspace.system.path``; an index's
directory is looked up case-insensitively among existing children so that
``myIndex`` and ``MYINDEX`` refer to the same index
(ref: HS/index/PathResolver.scala:30-70).
"""

from __future__ import annotations

import os
from typing import List

from hyperspace_tpu_torch.config import HyperspaceConf, INDEXES_DIR, keys


class PathResolver:
    def __init__(self, conf: HyperspaceConf):
        self.conf = conf

    @property
    def system_path(self) -> str:
        path = self.conf.system_path
        if not path:
            raise ValueError(
                f"Hyperspace system path is not set; set conf {keys.SYSTEM_PATH!r} "
                f"(the reference defaults to <warehouse>/{INDEXES_DIR})."
            )
        return str(path)

    def get_index_path(self, name: str) -> str:
        """Existing dir matching ``name`` case-insensitively, else the exact path."""
        root = self.system_path
        try:
            for child in os.listdir(root):
                if child.lower() == name.lower() and os.path.isdir(os.path.join(root, child)):
                    return os.path.join(root, child)
        except OSError:
            pass
        return os.path.join(root, name)

    def all_index_paths(self) -> List[str]:
        root = self.system_path
        try:
            return [
                os.path.join(root, child)
                for child in sorted(os.listdir(root))
                if os.path.isdir(os.path.join(root, child))
            ]
        except OSError:
            return []
