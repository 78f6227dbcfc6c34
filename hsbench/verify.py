"""The comparisons that decide ``correct``: each index's rows against its
source's, each template's rewrite against the index its configuration
names, and served answers against the plain references."""

from __future__ import annotations

import numpy as np

#: the numbers a run compares, each with its limit: how many requests failed
#: or never came, how many sampled answers differ in a group, a key, an
#: integer or their rows, the widest relative gap of a float against the
#: reference's float64, how many indexes hold other rows than their source,
#: and how many templates' plans read other indexes than configured
LIMITS = {"missing": 0, "wrong_answers": 0, "float_gap": 1e-9, "index_rows": 0, "rewrite": 0}

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix(z):
    """splitmix64's finaliser (uint64 arithmetic wraps)."""
    z = z ^ (z >> np.uint64(30))
    z = z * _M1
    z = z ^ (z >> np.uint64(27))
    z = z * _M2
    return z ^ (z >> np.uint64(31))


def _np(x):
    """An arrow array or chunked array as numpy."""
    return x.to_numpy() if hasattr(x, "num_chunks") else x.to_numpy(zero_copy_only=False)


def _words(src, idx):
    """Two arrow columns as uint64 words that are equal where the values are:
    strings by their position in the source's dictionary (a value missing
    from it gets a word no source value has), dates as days, numbers by
    their bits."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if pa.types.is_string(src.type) or pa.types.is_large_string(src.type) or pa.types.is_dictionary(src.type):
        src = src.cast(pa.string()) if pa.types.is_dictionary(src.type) else src
        idx = idx.cast(pa.string()) if pa.types.is_dictionary(idx.type) else idx
        enc = pc.dictionary_encode(src).combine_chunks()
        a = _np(enc.indices).astype(np.int64)
        b = _np(pc.index_in(idx, value_set=enc.dictionary).fill_null(-1)).astype(np.int64)
        b[b < 0] = -(1 << 40)
        return a.view(np.uint64), b.view(np.uint64)

    def num(c):
        v = _np(c)
        if v.dtype.kind == "M":
            v = v.astype("datetime64[D]").astype(np.int64)
        elif v.dtype == object:
            v = np.array(v, dtype="datetime64[D]").astype(np.int64)
        elif v.dtype.kind == "f":
            v = v.astype(np.float64)
        else:
            v = v.astype(np.int64)
        return np.ascontiguousarray(v).view(np.uint64)

    return num(src), num(idx)


def _digest(words_list):
    """(rows, two sums of per-row hashes): equal multisets of rows give
    equal digests."""
    h = np.zeros(len(words_list[0]), dtype=np.uint64)
    for i, w in enumerate(words_list):
        h = _mix(h ^ (w + np.uint64(i + 1)))
    g = _mix(h ^ np.uint64(0x9E3779B97F4A7C15))
    with np.errstate(over="ignore"):
        return len(h), int(h.sum(dtype=np.uint64)), int(g.sum(dtype=np.uint64))


def index_rows(deployment) -> dict:
    """{index: None if its files hold exactly the source's rows of its
    columns (as a multiset), else what differs}. The index's files are those
    its log entry names; both sides are read from parquet."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    out = {}
    for ix in deployment.cfg["indexes"]:
        cols = list(ix["indexed"]) + list(ix["included"])
        src_dir = deployment.tables[ix["table"]]["dir"]
        src = pq.read_table(src_dir, columns=cols)
        files = sorted(deployment.entries[ix["name"]].content.files)
        idx = pa.concat_tables([pq.read_table(f, columns=cols) for f in files]) if files else None
        if idx is None or idx.num_rows != src.num_rows:
            out[ix["name"]] = f"{0 if idx is None else idx.num_rows} rows, source {src.num_rows}"
            continue
        pairs = [_words(src.column(c), idx.column(c)) for c in cols]
        a, b = _digest([p[0] for p in pairs]), _digest([p[1] for p in pairs])
        out[ix["name"]] = None if a == b else f"row digest {b} against the source's {a}"
    return out


def plan_indexes(ctx, template, params) -> list:
    """The names of the indexes the optimized plan of one request reads."""
    from hyperspace_tpu_torch.plan import logical as L

    req = template.request(ctx, params)
    df = ctx.session.sql(req) if isinstance(req, str) else req
    return sorted({s.entry.name for s in L.collect(df.optimized_plan(), lambda p: isinstance(p, L.IndexScan))})


def _comparable(v):
    v = np.asarray(v)
    if v.dtype.kind == "M":
        return v.astype("datetime64[D]").astype(np.int64)
    if v.dtype.kind in "OUS":
        return v.astype(str)
    return v


def compare(got: dict, want: dict, keys, ordered: bool):
    """(wrong, widest float gap) of one answer against the reference's:
    ``wrong`` names what differs outside the floats (columns, rows, keys,
    integers), the gap is the widest |got - want| / |want| over the float
    columns."""
    if set(got) != set(want):
        return f"columns {sorted(got)} against {sorted(want)}", 0.0
    n = {len(np.asarray(v)) for v in want.values()} | {len(np.asarray(v)) for v in got.values()}
    if len(n) != 1:
        return f"rows {[len(np.asarray(v)) for v in got.values()]} against {n}", 0.0
    g = {c: np.asarray(v) for c, v in got.items()}
    w = {c: np.asarray(v) for c, v in want.items()}
    if not ordered and keys:
        g = {c: v[np.lexsort([_comparable(g[k]) for k in reversed(keys)])] for c, v in g.items()}
        w = {c: v[np.lexsort([_comparable(w[k]) for k in reversed(keys)])] for c, v in w.items()}
    gap = 0.0
    for c in w:
        if w[c].dtype.kind == "f":
            gv, wv = g[c].astype(np.float64), w[c].astype(np.float64)
            both_nan = np.isnan(gv) & np.isnan(wv)
            if np.any(np.isnan(gv) != np.isnan(wv)):
                return f"{c}: NaN where the reference has none, or none where it has one", gap
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(both_nan, 0.0, np.abs(gv - wv) / np.maximum(np.abs(wv), np.finfo(np.float64).tiny))
            gap = max(gap, float(rel.max()) if rel.size else 0.0)
        elif not np.array_equal(_comparable(g[c]), _comparable(w[c])):
            return f"{c}: {g[c][:4]} against {w[c][:4]}", gap
    return None, gap
