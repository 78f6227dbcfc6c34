"""Filesystem helpers.

The reference relies on the Hadoop FS API for atomic rename semantics
(ref: HS/util/FileUtils.scala, HS/index/IndexLogManager.scala:178-194).
Here we target POSIX local / fuse-mounted lake storage: the create-exclusive
primitive is ``os.link`` (fails if the target exists), giving the same
optimistic-concurrency guarantee.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Union

PathLike = Union[str, Path]


def write_atomic_exclusive(path: PathLike, data: bytes) -> bool:
    """Atomically create ``path`` with ``data`` iff it does not already exist.

    Returns True on success, False if the file already existed (another writer
    won the race). Mirrors the temp-file + atomic-rename protocol of
    HS/index/IndexLogManager.scala:178-194.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", dir=str(path.parent))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, str(path))  # atomic create-exclusive
            return True
        except FileExistsError:
            return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def write_atomic(path: PathLike, data: bytes) -> None:
    """Atomically (over)write ``path`` with ``data`` via temp + rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", dir=str(path.parent))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, str(path))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def walk_data_files(root: PathLike):
    """Yield data-file paths under ``root``, excluding hidden/meta entries
    (dot- or underscore-prefixed) at ANY depth — files and whole directories
    alike. The one DataPathFilter used by source listing and index-content
    scans (ref: HS/util/PathUtils.scala:33-39 DataPathFilter)."""
    import os

    for dirpath, dirs, names in os.walk(str(root)):
        dirs[:] = [d for d in dirs if not d.startswith((".", "_"))]
        for n in sorted(names):
            if not n.startswith((".", "_")):
                yield os.path.join(dirpath, n)


def delete_recursively(path: PathLike) -> None:
    path = Path(path)
    if path.is_dir():
        shutil.rmtree(path, ignore_errors=True)
    elif path.exists():
        path.unlink(missing_ok=True)
