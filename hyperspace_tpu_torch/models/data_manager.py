"""Versioned index-data directory manager.

Index data for version N lives in ``<index_root>/v__=N/``
(ref: HS/index/IndexDataManager.scala:24-74).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.utils.file_utils import delete_recursively

_VERSION_RE = re.compile(re.escape(C.INDEX_VERSION_DIR_PREFIX) + r"=(\d+)$")


class IndexDataManager:
    def __init__(self, index_path: str):
        self.index_path = str(index_path)

    def version_path(self, version: int) -> str:
        return os.path.join(self.index_path, f"{C.INDEX_VERSION_DIR_PREFIX}={version}")

    def get_all_versions(self) -> List[int]:
        try:
            names = os.listdir(self.index_path)
        except OSError:
            return []
        out = []
        for n in names:
            m = _VERSION_RE.match(n)
            if m and os.path.isdir(os.path.join(self.index_path, n)):
                out.append(int(m.group(1)))
        return sorted(out)

    def get_latest_version(self) -> Optional[int]:
        versions = self.get_all_versions()
        return versions[-1] if versions else None

    def allocate_version(self) -> int:
        """Claim the next data version by creating its directory exclusively;
        two concurrent writers can never share a version dir (defense in
        depth under the operation log's optimistic concurrency)."""
        latest = self.get_latest_version()
        version = 0 if latest is None else latest + 1
        while True:
            try:
                os.makedirs(self.version_path(version), exist_ok=False)
                return version
            except FileExistsError:
                version += 1

    def delete_version(self, version: int) -> None:
        delete_recursively(self.version_path(version))


class IndexDataManagerFactory:
    def create(self, index_path: str) -> IndexDataManager:
        return IndexDataManager(index_path)
