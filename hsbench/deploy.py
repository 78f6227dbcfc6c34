"""A configuration's deployment: its tables generated from the seed, a
``Session`` over them, its covering indexes built, hyperspace enabled."""

from __future__ import annotations

import os
import time

from hsbench import loader


class Deployment:
    def __init__(self, cfg, tables, session, frames, entries, seconds):
        self.cfg = cfg
        #: {table: {"dir": path, "columns": {column: array}}}, as generated
        self.tables = tables
        self.session = session
        #: {table: DataFrame over the table's files}
        self.frames = frames
        #: {index: the IndexLogEntry its create_index returned}
        self.entries = entries
        #: {"generate": s, "build": {index: s}}
        self.seconds = seconds


def build(cfg: dict, seed: int, root: str, device: str) -> Deployment:
    """Generate ``cfg``'s tables under ``root``, open a session of
    ``device`` with ``cfg``'s conf and its system path under ``root``,
    register the views and build each index (timed, synchronised on a card)."""
    import torch

    import hyperspace_tpu_torch as ht

    t = time.perf_counter()
    tables = loader.datagen(cfg["datagen"]).generate(os.path.join(root, "lake"), cfg["tables"], seed)
    seconds = {"generate": time.perf_counter() - t, "build": {}}
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: os.path.join(root, "indexes"), **cfg["session"]}, device=device)
    frames = {name: sess.read_parquet(t["dir"]) for name, t in tables.items()}
    for view in cfg.get("views", []):
        frames[view].create_or_replace_temp_view(view)
    hs = ht.Hyperspace(sess)
    entries = {}
    for ix in cfg["indexes"]:
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        entries[ix["name"]] = hs.create_index(frames[ix["table"]],
                                              ht.CoveringIndexConfig(ix["name"], ix["indexed"], ix["included"]))
        if device == "cuda":
            torch.cuda.synchronize()
        seconds["build"][ix["name"]] = time.perf_counter() - t
    sess.enable_hyperspace()
    return Deployment(cfg, tables, sess, frames, entries, seconds)


class Context:
    """What a template's ``request`` reads: the port's module and the frames."""

    def __init__(self, deployment: Deployment):
        import hyperspace_tpu_torch as ht

        self.ht = ht
        self.frames = deployment.frames
        self.session = deployment.session
