"""The device filter: the predicate of a ``Filter`` over an ``IndexScan``,
evaluated on the session's device.

The predicate tree compiles to a torch program over encoded device columns
(replaces Spark's per-bucket parquet scan + codegen'd filter; ref:
HS/index/covering/FilterIndexRule.scala:144-194). It is the port of the JAX
package's ``fused-filter`` XLA program (``hyperspace_tpu/exec/device.py``):
the same encodings, the same literal slots, the same Kleene (value, unknown)
pairs, the same rejections.

Strings are dictionary-encoded host-side; predicate literals are translated
into code space via the sorted dictionary, so <, <=, =, >=, > on strings all
lower to integer compares on the device. A string column the native decoder
read from dictionary pages (``B.DictBackedArray``) ships its int32 codes and
a remap table instead, and the ``dict-expand`` program ranks the codes on
the device into the same encoding.

Three torch semantics differ from JAX's under x64 and are handled here:
``int64 / int64`` is float32 in torch (float64 in JAX), so integer true
division casts to float64 first; integer ``%`` by zero raises or is undefined
in torch (0 in JAX), so zero divisors give 0; and a Python float against an
int64 tensor promotes to the default float32 in torch, so every literal goes
to the device as a 0-d tensor of its slot's dtype, which promotes as JAX
does.

Anything the device program cannot express raises ``DeviceUnsupported``
before a column is uploaded, and the executor (exec/executor.py) evaluates
the predicate on the host instead — mirroring how ``ApplyHyperspace`` never
fails a query (ref: HS/index/rules/ApplyHyperspace.scala:59-63). Errors of
the device itself (a failed launch, out of memory) propagate.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.obs import spans as obs_spans
from hyperspace_tpu_torch.plan.expr import (
    BinaryOp,
    Col,
    Expr,
    In,
    InputFileName,
    IsNull,
    Lit,
    Not,
)
from hyperspace_tpu_torch.reliability.faults import FAULTS
from hyperspace_tpu_torch.utils.lru import BytesLRU


class DeviceUnsupported(Exception):
    """Raised when an expression/plan shape cannot run on the device path."""


# --- declared program contracts (check/program_lint.py) ----------------------
# Each device-program family states its collective budget next to the code
# that builds it, with the JAX package's budgets one for one, and inherits
# the forbidden-op rules: no host wait, no f32->f64 array upcast, no
# value-dependent shape. With hyperspace.check.hlo.enabled on, each call
# site's maybe_verify() window records one live call of every new program
# and checks it.
_ANY = (0, None)
_program_lint.register_contract(
    "fused-filter",
    collectives={},
    description="fused predicate mask: elementwise over resident shards, shuffle-free",
)
_program_lint.register_contract(
    "fused-agg",
    collectives={"all-reduce": _ANY},
    description="fused filter+aggregate: scalar reductions may all-reduce, never move rows",
)
_program_lint.register_contract(
    "grouped-agg-chunk",
    collectives={"all-gather": _ANY, "all-reduce": _ANY},
    description="grouped-aggregate chunk: may gather fixed-size partials, never rows",
)
_program_lint.register_contract(
    "sharded-grouped",
    collectives={"all-gather": (1, None), "all-reduce": _ANY},
    description="sharded grouped chunk: all-gathers per-shard partial TABLES (>=1), never rows",
)
_program_lint.register_contract(
    "grouped-merge",
    collectives={},
    description="pairwise partial-aggregate merge: device-local, collective-free",
)
_program_lint.register_contract(
    "bucketed-smj-span",
    collectives={},
    description="bucketed sort-merge join span search: the shuffle-freedom claim itself",
)
_program_lint.register_contract(
    "fused-stage-agg",
    collectives={"all-gather": _ANY, "all-reduce": _ANY},
    description="whole-stage filter+group+state-merge with in-place fold state: one dispatch per chunk",
    single_fusion=True,
)
_program_lint.register_contract(
    "fused-stage-agg-sharded",
    collectives={"all-gather": (1, None), "all-reduce": _ANY},
    description="sharded whole-stage grouped fold: gathers per-shard partial TABLES (>=1), one dispatch",
    single_fusion=True,
)
_program_lint.register_contract(
    "dict-expand",
    collectives={},
    description="on-device dictionary expansion: codes gather a replicated remap table, shuffle-free",
    single_fusion=True,
)


#: device programs run per family since the last ``reset_dispatches()``
#: ("fused-filter": one per filter evaluated on the device; "dict-expand":
#: one per dictionary-coded string column uploaded; the broadcast join's
#: "hash-build", "hash-probe" and "fused-postjoin" in exec/join_stream.py;
#: the top-k's "topk-chunk" and "topk-merge" in exec/topk.py; the sharded
#: twins "sharded-grouped", "sharded-topk", "fused-stage-agg-sharded" and
#: "fused-stage-topk-sharded", parallel/collectives.py)
dispatches: collections.Counter = collections.Counter()


def reset_dispatches() -> None:
    dispatches.clear()


def count_dispatch(program: str) -> None:
    """Count one device-program dispatch under its family name, in
    ``dispatches`` and in the metrics registry's
    ``hs_device_dispatches_total{program}`` (the JAX package's name for the
    same count; ``reset_dispatches`` leaves the registry's running total)."""
    dispatches[program] += 1
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_device_dispatches_total",
        "Device-program dispatches, by program family",
        program=program,
    ).inc()


class ProgramClock:
    """The start of one device program's timing (``program_clock``): the
    host clock, and on a CUDA device an event recorded on the current
    stream before the program's first launch."""

    __slots__ = ("t0", "device", "start")

    def __init__(self, device: Optional[torch.device]):
        self.t0 = time.perf_counter()
        self.device = device
        self.start = None
        if device is not None and device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(device))


def program_key(family: str, skeleton: str, parallel=None) -> str:
    """A program's identity for contract verification:
    ``<family>/<skeleton>`` and, when sharded, its mesh (the JAX package's
    program-cache key, with the family in front so a finding names it)."""
    if parallel is None:
        return f"{family}/{skeleton}"
    from hyperspace_tpu_torch.parallel.mesh import mesh_fingerprint

    return f"{family}/{skeleton}@{mesh_fingerprint(parallel.mesh)}"


def program_clock(device: Optional[torch.device]) -> ProgramClock:
    """Start timing a device program on ``device``; hand the clock to
    ``_observe_program`` after the program."""
    return ProgramClock(device)


#: (family, start event, end event, span) of CUDA-timed programs whose end
#: event has not been seen complete yet
_pending_programs: collections.deque = collections.deque()
_pending_lock = threading.Lock()


def _record_program(family: str, seconds: float, sp) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.histogram(
        "hs_device_program_seconds",
        "seconds of device program invocations (CUDA events on the card, wall time on the CPU), by program family",
        program=family,
    ).observe(seconds)
    if sp is not None:
        sp.event("device-program", f"{family}: {seconds * 1e3:.2f} ms")


def _observe_program(family: str, clock: ProgramClock) -> None:
    """Per-program-family timing at the device programs' call sites: a
    histogram (``hs_device_program_seconds{program}``) and an event on the
    span active at the call.

    On a CUDA device the time is the device's own: an end event is recorded
    on the current stream here, and the interval between the clock's start
    event and it is read once the end event is complete, which never waits:
    right away when the call site has already synchronised (the copy of a
    mask or a count back), else at a later program's observation or at the
    end of the query (``resolve_program_timings``). Nothing here adds a
    synchronisation. On the CPU the time is the wall time since the clock
    started. The port's eager programs compile nothing, so it has no
    compile-seconds counter and no "(compile)" mark."""
    sp = obs_spans.current_span()
    if clock.start is None:
        _record_program(family, max(0.0, time.perf_counter() - clock.t0), sp)
        return
    end = torch.cuda.Event(enable_timing=True)
    end.record(torch.cuda.current_stream(clock.device))
    with _pending_lock:
        _pending_programs.append((family, clock.start, end, sp))
    resolve_program_timings()


def resolve_program_timings() -> int:
    """Record every pending CUDA-timed program whose end event is complete
    (``Event.query``, which does not wait); returns how many are left."""
    done = []
    with _pending_lock:
        keep = collections.deque()
        while _pending_programs:
            item = _pending_programs.popleft()
            (done if item[2].query() else keep).append(item)
        _pending_programs.extend(keep)
        left = len(_pending_programs)
    for family, start, end, sp in done:
        _record_program(family, start.elapsed_time(end) / 1e3, sp)
    return left


# Geometric sizes: powers of sqrt(2) over a floor. The JAX package pads its
# programs' inputs to them to bound XLA recompiles; torch compiles nothing,
# so the port keeps them only where they set a result's size (the top-k's
# candidate capacity).
_BUCKET_FLOOR = 4096
_SQRT2 = 1.4142135623730951


def bucket_rows(n: int, floor: int = _BUCKET_FLOOR) -> int:
    """Smallest geometric shape bucket (powers of sqrt(2) over ``floor``)
    holding ``n`` rows."""
    b = floor
    while b < n:
        b = int(b * _SQRT2) + 1
    return b


def topk_capacity(k: int, floor: int = 64) -> int:
    """Candidate-buffer capacity for a LIMIT ``k``: the same geometric
    buckets over a small floor, so nearby limits (10, 12, 100...) share one
    capacity."""
    return bucket_rows(max(1, int(k)), floor=max(1, int(floor)))


# --------------------------------------------------------------------------
# column encoding
# --------------------------------------------------------------------------


class ColumnCodec:
    """How one host column was encoded for the device.

    kind:
      - "numeric":  device tensor is the column itself (int64/float64; bool
                    as int64)
      - "datetime": device tensor is the int64 epoch view; ``unit`` remembers
                    the datetime64 unit for literal conversion
      - "string":   device tensor is int32 codes into ``uniques`` (sorted);
                    code -1 encodes null
    """

    def __init__(self, kind: str, uniques: Optional[np.ndarray] = None, unit: Optional[str] = None):
        self.kind = kind
        self.uniques = uniques
        self.unit = unit


def encode_column(arr: np.ndarray) -> Tuple[np.ndarray, ColumnCodec]:
    kind = arr.dtype.kind
    if kind in ("i", "u", "b"):
        return np.asarray(arr, dtype=np.int64), ColumnCodec("numeric")
    if kind == "f":
        return np.asarray(arr, dtype=np.float64), ColumnCodec("numeric")
    if kind == "M":
        unit = np.datetime_data(arr.dtype)[0]
        return arr.view("int64"), ColumnCodec("datetime", unit=unit)
    if kind in ("U", "S", "O"):
        from hyperspace_tpu_torch.ops.encode import factorize_strings

        codes, uniques, _ = factorize_strings(arr)
        return codes.astype(np.int32), ColumnCodec("string", uniques=uniques)
    raise DeviceUnsupported(f"unsupported column dtype {arr.dtype}")


def _literal_bounds(codec: ColumnCodec, value) -> Tuple[int, int]:
    """(lo, hi) code bounds of a literal in a string dictionary:
    col == lit ⇔ lo <= code < hi;  col < lit ⇔ code < lo;  col <= lit ⇔ code < hi."""
    lo = int(np.searchsorted(codec.uniques, str(value), side="left"))
    hi = int(np.searchsorted(codec.uniques, str(value), side="right"))
    return lo, hi


def _literal_numeric(codec: ColumnCodec, value):
    if codec.kind == "datetime":
        return int(np.datetime64(value, codec.unit).view("int64"))
    if isinstance(value, (bool, np.bool_)):
        return int(value)
    return value


# --------------------------------------------------------------------------
# predicate compiler: Expr tree -> torch program over encoded columns
#
# Literal values (and string-dictionary code bounds, which change per batch)
# are arguments of the program, not constants baked into it, exactly as in
# the JAX package, where they keep the XLA executable cache warm.
# --------------------------------------------------------------------------

_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}

#: NaT under the int64 epoch view
_NAT = np.iinfo(np.int64).min


class _LitSlots:
    """Collects literal values during compilation; each gets a slot index in
    the ``lits`` tuple passed to the compiled program at call time."""

    def __init__(self):
        self.values: List = []

    def add(self, value) -> int:
        self.values.append(value)
        return len(self.values) - 1


def predicate_skeleton(expr: Expr, codecs: Dict[str, ColumnCodec]) -> str:
    """Canonical structure of ``expr`` with literal *values* erased (the JAX
    package's program-cache key; the same string here)."""

    def lit_tag(v) -> str:
        if isinstance(v, str):
            return "s"
        if isinstance(v, (bool, np.bool_)):
            return "b"
        if isinstance(v, (int, np.integer)):
            return "i"
        if isinstance(v, np.datetime64):
            return "d"
        return "f"

    def rec(e: Expr) -> str:
        if isinstance(e, Col):
            return f"c:{e.name}:{codecs[e.name].kind if e.name in codecs else '?'}"
        if isinstance(e, Lit):
            return f"l:{lit_tag(e.value)}"
        if isinstance(e, BinaryOp):
            return f"({rec(e.left)}{e.op}{rec(e.right)})"
        if isinstance(e, Not):
            return f"!({rec(e.child)})"
        if isinstance(e, IsNull):
            return f"isnull({rec(e.child)})"
        if isinstance(e, In):
            return f"in({rec(e.child)},[{','.join(rec(v) for v in e.values)}])"
        if isinstance(e, InputFileName):
            return "input_file_name()"
        return f"{type(e).__name__}({','.join(rec(c) for c in e.children())})"

    return rec(expr)


def _or(a, b):
    """Elementwise OR of two unknown masks, None standing for all-False."""
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _known(v, u):
    """Definitely-true rows of a Kleene pair: ``v & ~u``."""
    return v if u is None else v & ~u


def _num_unknown(x):
    """NaN mask of a numeric tensor (None for integer tensors)."""
    return torch.isnan(x) if x.is_floating_point() else None


def _div(l, r):
    # JAX under x64 divides integers in float64; torch would use float32
    if not l.is_floating_point() and not r.is_floating_point():
        l, r = l.to(torch.float64), r.to(torch.float64)
    return l / r


def _mod(l, r):
    if l.is_floating_point() or r.is_floating_point():
        return torch.remainder(l, r)  # the sign of the divisor, as in JAX
    # JAX gives 0 for a zero divisor, where torch raises (CPU) or is
    # undefined (CUDA); x % -1 is 0 too, and skipping it spares the
    # INT64_MIN % -1 overflow
    special = (r == 0) | (r == -1)
    return torch.where(special, 0, torch.remainder(l, torch.where(special, 1, r)))


_ARITH = {
    "+": lambda l, r: l + r,
    "-": lambda l, r: l - r,
    "*": lambda l, r: l * r,
    "/": _div,
    "%": _mod,
}

_CMP = {
    "=": lambda l, r: l == r,
    "!=": lambda l, r: l != r,
    "<": lambda l, r: l < r,
    "<=": lambda l, r: l <= r,
    ">": lambda l, r: l > r,
    ">=": lambda l, r: l >= r,
}


def compile_predicate(expr: Expr, codecs: Dict[str, ColumnCodec]):
    """Compile ``expr`` into ``(fn, lit_values)`` where
    ``fn(cols: dict[str, Tensor], lits: tuple[Tensor]) -> bool mask`` and
    ``lit_values`` is the concrete literal tuple for this query (numpy
    scalars of each slot's dtype; ``upload_literals`` puts them on a device).

    Raises DeviceUnsupported for shapes outside the device language (string
    arithmetic, input_file_name(), col-vs-col string compares, ...) — the
    shapes the JAX package's compiler rejects. Compiling touches no device.

    Boolean subtrees evaluate to (value, unknown) Kleene pairs so NULL stays
    three-valued on the device exactly as on the host (expr.NullableBool): a
    NULL operand makes a comparison unknown — in particular NULL != x and
    NOT(NULL = x) must not come out true. ``None`` stands for an all-known
    mask. The program keeps definite-TRUE rows only (value & ~unknown).
    """
    slots = _LitSlots()

    def is_string_col(e: Expr) -> bool:
        return isinstance(e, Col) and codecs[e.name].kind == "string"

    def _const_subtree(e: Expr) -> bool:
        if isinstance(e, Lit):
            return True
        if isinstance(e, BinaryOp) and e.op in _ARITH:
            return _const_subtree(e.left) and _const_subtree(e.right)
        return False

    def _fold_const(e: Expr) -> Expr:
        """Fold literal-only arithmetic on the host: calendar-unit intervals
        (date '1994-01-01' + interval '1' year => timedelta64[M]) have no
        device dtype, but their folded result is a plain datetime scalar."""
        if isinstance(e, Lit) or not _const_subtree(e):
            return e
        v = e.eval({})
        arr = np.asarray(v)
        return Lit(arr.reshape(-1)[0] if arr.ndim else arr[()])

    def _has_datetime(e: Expr) -> bool:
        if isinstance(e, Col):
            return codecs[e.name].kind == "datetime"
        if isinstance(e, Lit):
            return isinstance(e.value, (np.datetime64, np.timedelta64))
        return any(_has_datetime(c) for c in e.children())

    def lit_slot(value):
        i = slots.add(_as_lit_scalar(value))
        return lambda cols, lits: lits[i]

    def build_num(e: Expr):
        """Numeric-valued subexpression -> device fn."""
        e = _fold_const(e)
        if isinstance(e, Col):
            if codecs[e.name].kind == "string":
                raise DeviceUnsupported("string column used in numeric context")
            name = e.name
            return lambda cols, lits: cols[name]
        if isinstance(e, Lit):
            v = e.value
            if isinstance(v, str):
                raise DeviceUnsupported("string literal in numeric context")
            if isinstance(v, np.datetime64):
                v = int(v.view("int64"))
            return lit_slot(v)
        if isinstance(e, BinaryOp) and e.op in _ARITH:
            lf, rf, op = build_num(e.left), build_num(e.right), _ARITH[e.op]
            return lambda cols, lits: op(lf(cols, lits), rf(cols, lits))
        raise DeviceUnsupported(f"unsupported numeric expr {type(e).__name__}")

    def num_unknown_expr(e: Expr):
        """NaT mask of a numeric-valued subexpression's datetime columns,
        propagated through arithmetic (None when it has none). Float NaN
        needs no mask here: it propagates through every arithmetic op, so
        the comparison's own NaN check on its operands covers it."""
        if isinstance(e, Col):
            if codecs[e.name].kind == "datetime":
                name = e.name
                return lambda cols, lits: cols[name] == _NAT
            return None
        if isinstance(e, BinaryOp) and e.op in _ARITH:
            lu, ru = num_unknown_expr(e.left), num_unknown_expr(e.right)
            if lu is None or ru is None:
                return lu or ru
            return lambda cols, lits: lu(cols, lits) | ru(cols, lits)
        return None

    def compare(lf, rf, op: str, lu=None, ru=None):
        cmp = _CMP[op]

        def f(cols, lits):
            l, r = lf(cols, lits), rf(cols, lits)
            u = _or(_num_unknown(l), _num_unknown(r))
            if lu is not None:
                u = _or(u, lu(cols, lits))
            if ru is not None:
                u = _or(u, ru(cols, lits))
            return cmp(l, r), u

        return f

    def string_compare(col: Col, op: str, lit_value):
        codec = codecs[col.name]
        if codec.kind != "string" or not isinstance(lit_value, str):
            # mixed-type compares have host-defined semantics; don't guess
            raise DeviceUnsupported("string compare requires string column and string literal")
        if op not in _CMP:
            raise DeviceUnsupported(f"unsupported string compare {op}")
        lo_v, hi_v = _literal_bounds(codec, lit_value)
        lo, hi = slots.add(np.int32(lo_v)), slots.add(np.int32(hi_v))
        name = col.name

        def f(cols, lits):
            c = cols[name]
            if op == "=":
                v = (c >= lits[lo]) & (c < lits[hi])
            elif op == "!=":
                v = (c < lits[lo]) | (c >= lits[hi])
            elif op == "<":
                v = c < lits[lo]
            elif op == "<=":
                v = c < lits[hi]
            elif op == ">":
                v = c >= lits[hi]
            else:
                v = c >= lits[lo]
            return v, c < 0  # the null code is -1

        return f

    def build_bool(e: Expr):
        if isinstance(e, BinaryOp) and e.op in ("AND", "OR"):
            lf, rf = build_bool(e.left), build_bool(e.right)
            if e.op == "AND":

                def f_and(cols, lits):
                    (lv, lu), (rv, ru) = lf(cols, lits), rf(cols, lits)
                    if lu is None and ru is None:
                        return lv & rv, None
                    # unknown unless either side is definitely false
                    return lv & rv, _or(lu, ru) & _or(lv, lu) & _or(rv, ru)

                return f_and

            def f_or(cols, lits):
                (lv, lu), (rv, ru) = lf(cols, lits), rf(cols, lits)
                lt, rt = _known(lv, lu), _known(rv, ru)
                if lu is None and ru is None:
                    return lt | rt, None
                return lt | rt, _or(lu, ru) & ~lt & ~rt

            return f_or
        if isinstance(e, Not):
            cf = build_bool(e.child)

            def f_not(cols, lits):
                v, u = cf(cols, lits)
                return ~v, u

            return f_not
        if isinstance(e, IsNull):
            c = e.child
            if not isinstance(c, Col):
                raise DeviceUnsupported("IS NULL on non-column")
            kind, name = codecs[c.name].kind, c.name

            def f_isnull(cols, lits):
                x = cols[name]
                if kind == "string":
                    return x < 0, None
                if kind == "datetime":
                    return x == _NAT, None
                if kind == "numeric" and x.dtype == torch.float64:
                    return torch.isnan(x), None
                return torch.zeros_like(x, dtype=torch.bool), None

            return f_isnull
        if isinstance(e, In):
            child = e.child
            if not isinstance(child, Col):
                raise DeviceUnsupported("IN on non-column")
            values = [v.value for v in e.values]
            if not values:
                raise DeviceUnsupported("empty IN list")
            if any(v is None or (isinstance(v, float) and v != v) for v in values):
                # NULL in the list makes non-matches unknown (host
                # _in_semantics); keep that shape host-side
                raise DeviceUnsupported("NULL literal in IN list")
            if is_string_col(child):
                if not all(isinstance(v, str) for v in values):
                    raise DeviceUnsupported("mixed-type IN on string column")
                terms = [string_compare(child, "=", val) for val in values]
            else:
                if any(isinstance(v, str) for v in values):
                    raise DeviceUnsupported("string IN value on non-string column")
                cf, cu = build_num(child), num_unknown_expr(child)
                terms = [
                    compare(cf, lit_slot(_literal_numeric(codecs[child.name], val)), "=", lu=cu)
                    for val in values
                ]

            def f_in(cols, lits):
                m, u = terms[0](cols, lits)  # all terms share the child's null mask
                for t in terms[1:]:
                    m = m | t(cols, lits)[0]
                return m, u

            return f_in
        if isinstance(e, BinaryOp) and e.op in _CMP:
            left, right, op = e.left, e.right, e.op
            # fold literal-only sides FIRST so a folded datetime constant
            # takes the Col-vs-Lit path below, where _literal_numeric
            # converts it to the column codec's epoch unit
            left, right = _fold_const(left), _fold_const(right)
            # normalize: Col OP Lit
            if isinstance(right, Col) and isinstance(left, Lit):
                left, right, op = right, left, _FLIP[op]
            if isinstance(left, Col) and isinstance(right, Lit):
                codec = codecs[left.name]
                if codec.kind == "string" or isinstance(right.value, str):
                    if codec.kind != "string":
                        raise DeviceUnsupported("string literal vs non-string column")
                    return string_compare(left, op, right.value)
                val = _literal_numeric(codec, right.value)
                return compare(build_num(left), lit_slot(val), op, lu=num_unknown_expr(left))
            # general numeric compare (col-vs-col, arithmetic): datetime
            # operands have per-column epoch units the generic path cannot
            # reconcile — reject rather than compare mismatched units
            for side in (left, right):
                if _has_datetime(side):
                    raise DeviceUnsupported("datetime arithmetic compare on device")
            return compare(
                build_num(left), build_num(right), op,
                lu=num_unknown_expr(left), ru=num_unknown_expr(right),
            )
        if isinstance(e, InputFileName):
            raise DeviceUnsupported("input_file_name() is host-only")
        raise DeviceUnsupported(f"unsupported boolean expr {type(e).__name__}")

    pred = build_bool(expr)

    def fn(cols, lits):
        return _known(*pred(cols, lits))

    return fn, tuple(slots.values)


def _as_lit_scalar(v):
    """Fix the dtype a literal is passed with: numpy scalars keep theirs,
    Python ints and bools are int64, other numbers float64."""
    if isinstance(v, (np.timedelta64, np.datetime64)):
        # calendar units have no device dtype
        raise DeviceUnsupported(f"literal dtype {type(v).__name__} not device-representable")
    if isinstance(v, np.generic):
        return v
    if isinstance(v, bool):
        return np.int64(v)
    if isinstance(v, int):
        return np.int64(v)
    if isinstance(v, (str, bytes)):
        raise DeviceUnsupported("string literal in numeric slot")
    return np.float64(v)


def _pack_literals(values) -> Tuple[np.ndarray, List[torch.dtype]]:
    """Every literal slot in 8 bytes of one host buffer, with its dtype."""
    raw = np.zeros(8 * len(values), dtype=np.uint8)
    dtypes = []
    for i, v in enumerate(values):
        a = np.asarray(v).reshape(1)
        if a.dtype.kind not in ("b", "i", "u", "f") or a.dtype.itemsize > 8:
            raise DeviceUnsupported(f"literal dtype {a.dtype} not device-representable")
        raw[8 * i: 8 * i + a.dtype.itemsize] = a.view(np.uint8)
        dtypes.append(torch.from_numpy(a).dtype)
    return raw, dtypes


def upload_literals(values, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The literal slots as 0-d tensors of their dtypes on ``device``, put
    there with one host-to-device copy: views into one uploaded buffer."""
    if not values:
        return ()
    raw, dtypes = _pack_literals(values)
    buf = torch.from_numpy(raw).to(device)
    return tuple(
        buf[8 * i: 8 * i + dt.itemsize].view(dt).reshape(()) for i, dt in enumerate(dtypes)
    )


# --------------------------------------------------------------------------
# device column cache: (scan identity, column, device) -> (tensor, codec,
# n_rows, ready). Index bucket files are immutable (versioned v__=N dirs), so
# predicate columns stay resident on the device across queries; only the
# first query on an index version pays the host->device copy. The scan
# identity holds each file's mtime and size, so a rewrite invalidates.
# ``ready`` is the CUDA event after the copy of a column staged on a
# pipeline thread's side stream (``stage_filter_columns``), else None.
# --------------------------------------------------------------------------

_device_cache = BytesLRU(int(os.environ.get("HS_DEVICE_CACHE_BYTES", 1 << 31)))


def clear_device_cache() -> None:
    """Drop every resident column and rectangle, and the grouped
    aggregate's capacity hints (as the JAX package's clear does)."""
    from hyperspace_tpu_torch.exec import aggregate

    _device_cache.clear()
    aggregate._CAP_HINT_MEMO.clear()


def _dry_codecs(batch: B.Batch, refs) -> Dict[str, ColumnCodec]:
    """Dtype-kind-only codecs for the pre-transfer support check (string
    bounds resolve to 0; values are discarded)."""
    out: Dict[str, ColumnCodec] = {}
    for r in refs:
        kind = batch[r].dtype.kind
        if kind in ("U", "S", "O"):
            out[r] = ColumnCodec("string", uniques=np.empty(0, dtype=str))
        elif kind == "M":
            out[r] = ColumnCodec("datetime", unit=np.datetime_data(batch[r].dtype)[0])
        elif kind in ("i", "u", "b", "f"):
            out[r] = ColumnCodec("numeric")
        else:
            raise DeviceUnsupported(f"unsupported column dtype {batch[r].dtype}")
    return out


def purge_device_cache_files(paths) -> int:
    """Drop every resident device column whose scan covers any of ``paths``
    (commit invalidation, lifecycle/invalidation.py); returns the entries
    removed. Column keys are ``(scan_key, column, device)``, and a scan key
    is a tuple of ``(path, mtime_ns, size)`` triples (with a pruning marker
    after them, where there is one)."""
    wanted = set(paths)
    if not wanted:
        return 0
    removed = 0
    for key in _device_cache.keys():
        scan_key = key[0] if isinstance(key, tuple) and key else None
        if not isinstance(scan_key, tuple):
            continue
        hit = any(isinstance(part, tuple) and part and part[0] in wanted for part in scan_key)
        if hit and _device_cache.discard(key):
            removed += 1
    return removed


def _host_tensor(enc: np.ndarray) -> torch.Tensor:
    with warnings.catch_warnings():
        # scan-cache arrays are read-only; the upload only reads them
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(enc))


def _staging_host(enc: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host tensor a copy to ``device`` reads: the array's own memory,
    which for a column the native decoder wrote under a CUDA session is
    already pinned (exec/io.py ``set_pinned_decode``); any other array is
    copied into pinned memory first when the copy goes to a CUDA device."""
    host = _host_tensor(enc)
    if device.type == "cuda" and not host.is_pinned():
        host = host.pin_memory()
    return host


def dict_expand_program(codes: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """"dict-expand": each int32 dictionary code to its rank in the sorted
    dictionary through the remap table, -1 (null) kept. The gather index is
    clamped into the table, so a -1 code never indexes (an out-of-range
    gather is a device assert on CUDA)."""
    idx = codes.clamp(0, remap.shape[0] - 1).long()
    return torch.where(codes >= 0, remap[idx], torch.full_like(codes, -1))


def dict_expand_plain(codes: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """The numpy version of ``dict_expand_program``."""
    return np.where(codes >= 0, remap[np.clip(codes, 0, remap.shape[0] - 1)], np.int32(-1)).astype(np.int32)


def _dict_plan(arr: np.ndarray):
    """(int32 codes, remap table, codec) of a dictionary-backed string column
    (``B.DictBackedArray`` from the native decoder), else None. The remap
    table maps a code to its rank among the sorted dictionary entries; its
    length is a power of two. The codec's uniques are the sorted entries,
    so literal bounds resolve as on the ``factorize_strings`` path."""
    codes = getattr(arr, "hs_dict_codes", None)
    uniques = getattr(arr, "hs_dict_uniques", None)
    if codes is None or uniques is None or codes.shape[0] != arr.shape[0]:
        return None
    order = np.argsort(uniques, kind="stable")
    k = int(order.shape[0])
    rank = np.empty(k, dtype=np.int32)
    rank[order] = np.arange(k, dtype=np.int32)
    cap = 1
    while cap < max(k, 1):
        cap *= 2
    remap = np.zeros(cap, dtype=np.int32)
    remap[:k] = rank
    return np.ascontiguousarray(codes, dtype=np.int32), remap, ColumnCodec("string", uniques=uniques[order])


def _encoded_for_upload(arr: np.ndarray):
    """(host array to copy, remap table or None, codec) of one column: a
    dictionary-backed string column's int32 codes and remap table
    (``_dict_plan``), else ``encode_column``'s encoding."""
    plan = _dict_plan(arr)
    if plan is not None:
        return plan
    enc, codec = encode_column(arr)
    return enc, None, codec


def _dict_expand(codes_dev: torch.Tensor, remap: np.ndarray, device: torch.device) -> torch.Tensor:
    remap_dev = _host_tensor(remap).to(device)
    t0 = program_clock(device)
    # no session conf reaches the upload: the module default is the switch
    with _program_lint.maybe_verify(None, "dict-expand", "dict-expand/remap", (codes_dev, remap_dev)):
        out = dict_expand_program(codes_dev, remap_dev)
    count_dispatch("dict-expand")
    _observe_program("dict-expand", t0)
    return out


def _put_encoded(arr: np.ndarray, device: torch.device) -> Tuple[torch.Tensor, ColumnCodec, int]:
    """Encode and upload one column; returns (tensor, codec, bytes). A
    dictionary-backed string column uploads its int32 codes and the remap
    table, and ``dict-expand`` ranks them on the device."""
    enc, remap, codec = _encoded_for_upload(arr)
    dev = _host_tensor(enc).to(device)
    if remap is None:
        return dev, codec, int(enc.nbytes)
    return _dict_expand(dev, remap, device), codec, int(enc.nbytes + remap.nbytes)


def _cached_column(ckey, n: int):
    """(tensor, codec) of a resident column of ``n`` rows, or None. A column
    staged on a pipeline thread's side stream becomes usable here: the
    current stream waits for its copy's event, and the tensor is recorded
    on the current stream, so the caching allocator never hands its memory
    out while this stream's programs may still read it."""
    cached = _device_cache.get(ckey) if ckey is not None else None
    if cached is None or cached[2] != n:
        return None
    dev, codec, _, ready = cached
    if ready is not None:
        stream = torch.cuda.current_stream(dev.device)
        stream.wait_event(ready)
        dev.record_stream(stream)
    return dev, codec


def resolved_device(session) -> torch.device:
    """The session's device with its index: a pipeline thread's current
    CUDA device need not be the consumer thread's."""
    device = session.device
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


_STAGE_STREAMS = threading.local()


def _stage_encoded(arr: np.ndarray, device: torch.device):
    """Encode one column and copy it to ``device`` from the calling
    thread: on CUDA from pinned host memory (the native decoder's buffer
    where it is pinned, else a pinned copy) on the thread's own side
    stream, followed by an event the consumer waits on. Returns (tensor,
    codec, bytes, ready event or None)."""
    if device.type != "cuda":
        dev, codec, nbytes = _put_encoded(arr, device)
        return dev, codec, nbytes, None
    torch.cuda.set_device(device)
    streams = getattr(_STAGE_STREAMS, "by_device", None)
    if streams is None:
        streams = _STAGE_STREAMS.by_device = {}
    stream = streams.get(device.index)
    if stream is None:
        stream = streams[device.index] = torch.cuda.Stream(device)
    enc, remap, codec = _encoded_for_upload(arr)
    host = _staging_host(enc, device)
    with torch.cuda.stream(stream):
        dev = host.to(device, non_blocking=True)
        nbytes = int(enc.nbytes)
        if remap is not None:
            dev = _dict_expand(dev, remap, device)
            nbytes += int(remap.nbytes)
        ready = torch.cuda.Event()
        ready.record(stream)
    if host.data_ptr() == enc.ctypes.data:
        # the copy reads the pinned decode buffer itself, which the caching
        # host allocator does not track for this copy: the buffer must
        # outlive it, so this producer thread waits for the copy
        ready.synchronize()
    return dev, codec, nbytes, ready


def stage_filter_columns(session, batch: B.Batch, condition: Optional[Expr], scan_key, extra_columns=None,
                         device: Optional[torch.device] = None) -> None:
    """The scan pipeline's staging hook (exec/pipeline.py): encode
    ``condition``'s columns and ``extra_columns`` (group keys, aggregate
    inputs) of a chunk and copy them into the device column cache from the
    producer thread, so the consumer's program over the chunk finds them
    resident and the copy overlaps the previous chunk's compute.
    ``device`` is the session's device with its index (``resolved_device``,
    taken on the consumer thread). Each entry enters the cache only with
    its copy's event. A no-op when the predicate is outside the device
    language or ``scan_key`` is None (nothing would be cached). The JAX
    package's ``parallel=`` (the mesh to stage onto) has no counterpart: a
    column stages whole onto the session's device, the mesh's first, and
    the sharded programs take their shards' row blocks from the cached
    column, so both modes share one cache entry."""
    if scan_key is None or (condition is None and not extra_columns):
        return
    n = B.num_rows(batch)
    if n == 0:
        return
    refs = sorted(condition.references()) if condition is not None else []
    if any(r not in batch for r in refs):
        return
    cols = list(dict.fromkeys(refs + [c for c in (extra_columns or []) if c in batch]))
    target = device if device is not None else session.device
    try:
        if condition is not None:
            _pack_literals(compile_predicate(condition, _dry_codecs(batch, refs))[1])
        if FAULTS.active:
            FAULTS.check("device.transfer")
        with obs_spans.span("h2d-stage", cat="pipeline", rows=n):
            for r in cols:
                ckey = (scan_key, r, str(session.device))
                cached = _device_cache.get(ckey)
                if cached is not None and cached[2] == n:
                    continue
                dev, codec, nbytes, ready = _stage_encoded(batch[r], target)
                _device_cache.put(ckey, (dev, codec, n, ready), nbytes)
    except DeviceUnsupported:
        return  # the consumer's own path takes this chunk


def device_filter_mask(session, batch: B.Batch, condition: Expr, scan_key=None, parallel=None) -> np.ndarray:
    """Evaluate ``condition`` on the session's device over the referenced
    columns of ``batch``; returns the host bool mask. Raises
    DeviceUnsupported when the predicate is outside the device language.

    ``scan_key`` identifies an immutable file set (IndexScan bucket files);
    when given, encoded predicate columns stay resident on the device across
    queries. ``parallel`` (a ``ShardedExecutor``) evaluates the predicate
    per shard of its mesh (``parallel/collectives.sharded_elementwise``);
    the column cache is the same in both modes."""
    device = session.device
    refs = sorted(condition.references())
    for r in refs:
        if r not in batch:
            raise DeviceUnsupported(f"referenced column {r!r} missing from batch")
    n = B.num_rows(batch)
    if n == 0:
        return np.zeros(0, dtype=bool)

    dev_cols: Dict[str, torch.Tensor] = {}
    codecs: Dict[str, ColumnCodec] = {}
    missing: List[str] = []
    for r in refs:
        ckey = (scan_key, r, str(device)) if scan_key is not None else None
        cached = _cached_column(ckey, n)
        if cached is not None:
            dev_cols[r], codecs[r] = cached
        else:
            missing.append(r)

    stages = session.query_stage_seconds
    if missing:
        # reject unsupported predicates BEFORE encoding/transferring the
        # missing columns — an unsupported shape must not cost device memory
        # or a wasted upload
        _pack_literals(compile_predicate(condition, _dry_codecs(batch, refs))[1])
        t = time.perf_counter()
        for r in missing:
            dev, codec, nbytes = _put_encoded(batch[r], device)
            dev_cols[r], codecs[r] = dev, codec
            if scan_key is not None:
                _device_cache.put((scan_key, r, str(device)), (dev, codec, n, None), nbytes)
        stages["upload"] += time.perf_counter() - t

    t = time.perf_counter()
    clock = program_clock(device)
    fn, lit_values = compile_predicate(condition, codecs)
    if parallel is not None:
        from hyperspace_tpu_torch.parallel import collectives as C

        fn = C.sharded_elementwise(parallel.mesh, parallel.axis, fn)
        parallel.note_op("filter")
    lits = upload_literals(lit_values, device)
    with _program_lint.maybe_verify(
        session.conf, "fused-filter", lambda: program_key("fused-filter", predicate_skeleton(condition, codecs),
                                                          parallel), (dev_cols, lits)):
        mask = fn(dev_cols, lits)
    count_dispatch("fused-filter")
    if mask.dim() == 0:  # a predicate over literals only
        mask = mask.expand(n)
    t1 = time.perf_counter()
    stages["predicate_launch"] += t1 - t
    out = mask.cpu().numpy()
    stages["wait_copy_mask"] += time.perf_counter() - t1
    _observe_program("fused-filter", clock)
    return out
