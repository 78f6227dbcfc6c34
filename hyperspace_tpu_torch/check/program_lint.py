"""Device-program contracts over a torch program's recorded dispatch.

The counterpart of the JAX package's ``hyperspace_tpu/check/hlo_lint.py``,
with its API and rule names. There each device-program family declares a
collective budget and forbidden-op patterns, and the engine reads them off
the compiled HLO text. A torch program compiles to no text; what it does is
the stream of aten ops it dispatches and the collectives it calls, so that
is the program text here:

- each family **declares** its contract at registration
  (:func:`register_contract`, called next to the program builders in
  ``exec/device.py``, ``exec/join_stream.py``, ``exec/lineage.py``,
  ``exec/stage_ir.py``, ``ops/bucketize.py`` and ``ops/sort.py``),
- a :class:`ProgramRecord` holds one live invocation: every aten op it
  dispatched (a ``TorchDispatchMode``, which is per thread, so a pipeline
  thread's program never mixes with another's) with its inputs' and
  outputs' dtypes, devices and sizes, and the collectives it called
  (``parallel/mesh.py``'s per-thread listener, by op and axis),
- :func:`verify_program` checks a record against its family's contract,
- :func:`maybe_verify` is the runtime hook: default-off behind
  ``hyperspace.check.hlo.enabled`` (the JAX package's key, kept for the
  shared docs), it returns a window to run the program in, which records
  the live call once per (program key, shape signature) and never runs the
  program again (fold state is updated in place), bumping
  ``hs_check_programs_verified_total{program}`` and
  ``hs_check_violations_total{rule,program}``.

What the rules mean for a torch program:

- ``collective-budget:<op>``: the collectives the program called, against
  the budget, as in the JAX package;
- ``forbidden-op:host-callback``: the program waits on the device for a
  value mid-flight (``aten::_local_scalar_dense`` behind ``.item()``,
  ``int(t)`` and ``bool(t)``; ``aten::nonzero``; ``aten::is_nonzero``;
  ``aten::equal``; a copy from the program's CUDA device to the CPU). On
  the card the host stops enqueueing work until the device catches up;
- ``forbidden-op:f64-upcast``: a float32 tensor of more than one element
  becomes float64 (a conversion, a copy or a promoting op); a scalar is
  fine;
- ``forbidden-op:dynamic-shape``: an op whose output size depends on
  values (``nonzero``, ``masked_select``, the ``unique`` family,
  ``index.Tensor`` with a boolean index, ``repeat_interleave`` without
  ``output_size``);
- ``single-fusion``: the torch meaning of "one executable": the window
  holds no host wait and no value-dependent shape, so the host enqueues the
  whole stage without stopping. It holds whatever ``forbid`` opts out of.

Not seen: the hand-written kernels (``ops/kernels.py``, ``native/``) are
called through ``ctypes``, not the aten dispatcher, so their launches are
not ops of the record (the tensors they read and write are made by aten
ops, which are). The disabled path is one conf lookup.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from hyperspace_tpu_torch.check.findings import Finding

COLLECTIVE_OPS = (
    "all-to-all",
    "all-gather",
    "collective-permute",
    "all-reduce",
    "reduce-scatter",
)

# ops that move row data between devices: their absence is the reference's
# shuffle-freedom claim. all-reduce stays out of this set — a scalar
# reduction is not a data shuffle.
SHUFFLE_OPS = ("all-to-all", "all-gather", "collective-permute", "reduce-scatter")


# --------------------------------------------------------------------------
# the program text: a recorded dispatch
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op: ``name`` is the schema name
    (``aten::nonzero``), ``overload`` its overload (``Tensor``); the
    tensors' dtypes, devices and element counts, inputs and outputs in
    argument order. ``bool_index`` marks an ``index`` with a boolean index
    tensor, ``sized`` a ``repeat_interleave`` given its ``output_size``."""

    name: str
    overload: str
    in_dtypes: Tuple[torch.dtype, ...]
    in_devices: Tuple[str, ...]
    in_numels: Tuple[int, ...]
    out_dtypes: Tuple[torch.dtype, ...]
    out_devices: Tuple[str, ...]
    out_numels: Tuple[int, ...]
    bool_index: bool = False
    sized: bool = False

    @property
    def label(self) -> str:
        return self.name if self.overload in ("", "default") else f"{self.name}.{self.overload}"


@dataclass
class ProgramRecord:
    """One live invocation of a device program: its aten ops, in dispatch
    order, and its collectives as ``(op, axis)``."""

    ops: List[OpRecord] = field(default_factory=list)
    collectives: List[Tuple[str, str]] = field(default_factory=list)


def collective_counts(record: ProgramRecord) -> Dict[str, int]:
    """Calls of each collective op in a recorded program."""
    counts = {k: 0 for k in COLLECTIVE_OPS}
    for op, _axis in record.collectives:
        counts[op] += 1
    return counts


def assert_shuffle_free(record: ProgramRecord, context: str = "") -> None:
    """Assert the program exchanges NO row data between devices."""
    got = collective_counts(record)
    bad = {op: got[op] for op in SHUFFLE_OPS if got[op]}
    assert not bad, (
        f"{context or 'program'}: expected a shuffle-free program but it called "
        f"data-movement collectives {bad} (all counts: {got})"
    )


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _bool_index(func, args) -> bool:
    if func._schema.name != "aten::index":
        return False
    indices = args[1] if len(args) > 1 else ()
    return any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8) for t in indices or ())


class _Recorder(TorchDispatchMode):
    """Appends each dispatched aten op to a record. A dispatch mode is per
    thread: ops another thread dispatches meanwhile are not seen."""

    def __init__(self, record: ProgramRecord):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.record.ops.append(OpRecord(
            name=str(func._schema.name),
            overload=func._overloadname,
            in_dtypes=tuple(t.dtype for t in ins),
            in_devices=tuple(str(t.device) for t in ins),
            in_numels=tuple(int(t.numel()) for t in ins),
            out_dtypes=tuple(t.dtype for t in outs),
            out_devices=tuple(str(t.device) for t in outs),
            out_numels=tuple(int(t.numel()) for t in outs),
            bool_index=_bool_index(func, args),
            sized=kwargs.get("output_size") is not None,
        ))
        return out


@contextlib.contextmanager
def recording():
    """Record every aten op this thread dispatches and every collective it
    calls inside the block; yields the :class:`ProgramRecord`."""
    from hyperspace_tpu_torch.parallel import mesh

    record = ProgramRecord()
    with mesh.listening_collectives(record.collectives), _Recorder(record):
        yield record


def record_of(fn, *args, **kwargs) -> ProgramRecord:
    """The recorded dispatch of one call of ``fn`` on the given arguments —
    the artifact the rules inspect (the counterpart of ``hlo_text_of``)."""
    with recording() as record:
        fn(*args, **kwargs)
    return record


# --------------------------------------------------------------------------
# forbidden-op rules (apply to every family unless opted out)
# --------------------------------------------------------------------------

_HOST_WAIT_OPS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero", "aten::equal"}
_COPY_OPS = {"aten::_to_copy", "aten::copy_"}
_DYNAMIC_OPS = {
    "aten::nonzero",
    "aten::masked_select",
    "aten::_unique",
    "aten::_unique2",
    "aten::unique_dim",
    "aten::unique_consecutive",
    "aten::unique_dim_consecutive",
}


def _device_to_host(op: OpRecord) -> bool:
    if op.name not in _COPY_OPS:
        return False
    if op.name == "aten::copy_":  # copy_(dst, src): dst is the first input
        return len(op.in_devices) >= 2 and op.in_devices[0] == "cpu" and op.in_devices[1].startswith("cuda")
    return any(d.startswith("cuda") for d in op.in_devices) and any(d == "cpu" for d in op.out_devices)


def host_wait(op: OpRecord) -> bool:
    """The op makes the host wait for the device's value."""
    return op.name in _HOST_WAIT_OPS or _device_to_host(op)


def f64_upcast(op: OpRecord) -> bool:
    """A float32 tensor of more than one element becomes float64."""
    f32_in = any(dt == torch.float32 and n > 1 for dt, n in zip(op.in_dtypes, op.in_numels))
    f64_out = any(dt == torch.float64 and n > 1 for dt, n in zip(op.out_dtypes, op.out_numels))
    return f32_in and f64_out


def dynamic_shape(op: OpRecord) -> bool:
    """The op's output size depends on the values of its inputs."""
    if op.name in _DYNAMIC_OPS:
        return True
    if op.name == "aten::index" and op.bool_index:
        return True
    return op.name == "aten::repeat_interleave" and not op.sized


#: (rule name, predicate over one op, human description)
FORBIDDEN_PATTERNS = (
    ("host-callback", host_wait,
     "host wait inside a device program (.item()/int()/bool() of a tensor, nonzero, equal, a device-to-host copy)"),
    ("f64-upcast", f64_upcast,
     "whole-array f32->f64 conversion (doubles the footprint; stage f64 or compute in f32)"),
    ("dynamic-shape", dynamic_shape,
     "value-dependent output size (the host must learn it before it can go on; pad to a bound instead)"),
)


# --------------------------------------------------------------------------
# contracts
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ProgramContract:
    """Declared collective budget for one device-program family.

    ``collectives`` maps op name -> (min, max) calls in one invocation
    (``max=None`` = unbounded). Ops not listed must not appear at all — a
    contract says everything it permits. ``forbid`` names which
    :data:`FORBIDDEN_PATTERNS` rules apply (default: all).

    ``single_fusion`` asserts the whole-stage guarantee: the host enqueues
    the stage without stopping — no host wait and no value-dependent shape
    in the window, whatever ``forbid`` says.
    """

    family: str
    collectives: Dict[str, Tuple[int, Optional[int]]] = field(default_factory=dict)
    forbid: Tuple[str, ...] = tuple(name for name, _, _ in FORBIDDEN_PATTERNS)
    description: str = ""
    single_fusion: bool = False


_CONTRACTS: Dict[str, ProgramContract] = {}
_CONTRACTS_LOCK = threading.Lock()


def register_contract(
    family: str,
    collectives: Optional[Dict[str, Tuple[int, Optional[int]]]] = None,
    forbid: Optional[Tuple[str, ...]] = None,
    description: str = "",
    single_fusion: bool = False,
) -> ProgramContract:
    """Declare (or re-declare, idempotently) a program family's contract.
    Called next to the program builders so the budget lives with the code it
    constrains."""
    c = ProgramContract(
        family=family,
        collectives=dict(collectives or {}),
        forbid=tuple(forbid) if forbid is not None else tuple(n for n, _, _ in FORBIDDEN_PATTERNS),
        description=description,
        single_fusion=bool(single_fusion),
    )
    with _CONTRACTS_LOCK:
        _CONTRACTS[family] = c
    return c


def contract_for(family: str) -> Optional[ProgramContract]:
    with _CONTRACTS_LOCK:
        return _CONTRACTS.get(family)


def registered_contracts() -> Dict[str, ProgramContract]:
    with _CONTRACTS_LOCK:
        return dict(_CONTRACTS)


def _matches(record: ProgramRecord, pred) -> Counter:
    return Counter(op.label for op in record.ops if pred(op))


def _listing(hits: Counter) -> str:
    return ", ".join(f"{n} x {label}" for label, n in sorted(hits.items()))


def verify_program(family: str, record: ProgramRecord, program: str = "") -> List[Finding]:
    """Check a recorded program against ``family``'s declared contract.
    Returns one Finding per violated rule (empty = conformant). Raises
    KeyError for an undeclared family — an unknown family is a lint bug,
    not a clean program."""
    contract = contract_for(family)
    if contract is None:
        raise KeyError(
            f"no contract registered for program family {family!r} "
            f"(registered: {sorted(_CONTRACTS)})"
        )
    label = f"program:{program or family}"
    findings: List[Finding] = []
    got = collective_counts(record)
    for op in COLLECTIVE_OPS:
        lo, hi = contract.collectives.get(op, (0, 0))
        n = got[op]
        if n < lo or (hi is not None and n > hi):
            budget = f"exactly {lo}" if lo == hi else (f">= {lo}" if hi is None else f"{lo}..{hi}")
            findings.append(Finding(
                rule=f"collective-budget:{op}",
                path=label,
                line=0,
                message=f"{family}: {n} x {op} in the recorded program, contract allows {budget} (all counts: {got})",
                detail={"family": family, "op": op, "count": n},
            ))
    if contract.single_fusion:
        stops = _matches(record, lambda o: host_wait(o) or dynamic_shape(o))
        if stops:
            findings.append(Finding(
                rule="single-fusion",
                path=label,
                line=0,
                message=(
                    f"{family}: whole-stage contract expects the host to enqueue the stage "
                    f"without stopping; the window stops it at {_listing(stops)}"
                ),
                detail={"family": family, "ops": dict(stops), "count": sum(stops.values())},
            ))
    active = set(contract.forbid)
    for name, pred, desc in FORBIDDEN_PATTERNS:
        if name not in active:
            continue
        hits = _matches(record, pred)
        if hits:
            findings.append(Finding(
                rule=f"forbidden-op:{name}",
                path=label,
                line=0,
                message=f"{family}: {desc} ({_listing(hits)})",
                detail={"family": family, "ops": dict(hits), "count": sum(hits.values())},
            ))
    return findings


def assert_contract(family: str, record: ProgramRecord, program: str = "") -> None:
    """Raise AssertionError listing every violation."""
    findings = verify_program(family, record, program)
    assert not findings, "program contract violations:\n" + "\n".join(f.render() for f in findings)


# --------------------------------------------------------------------------
# runtime hook: record and verify one live call of each new program
# --------------------------------------------------------------------------

#: module-level default for call sites with no session conf in reach (the
#: index-build exchange); the most recently constructed Session's conf wins,
#: as in the JAX package
_default_enabled = False

_VERIFIED_SEEN: set = set()
_SEEN_LOCK = threading.Lock()
_VIOLATIONS: List[Finding] = []
#: CUDA synchronisations that ``torch.cuda.set_sync_debug_mode("warn")``
#: reported inside recorded windows, by (family, the Python line that
#: caused it) (``count_syncs``)
_SYNCS: Counter = Counter()
_count_syncs = False

_CONF_KEY = "hyperspace.check.hlo.enabled"


def set_default_enabled(on: bool) -> None:
    global _default_enabled
    _default_enabled = bool(on)


def count_syncs(on: bool) -> None:
    """Also run each recorded window on a CUDA device under
    ``torch.cuda.set_sync_debug_mode("warn")`` and count the
    synchronisations CUDA reports (``runtime_syncs``). A diagnostic for one
    thread at a time: the debug mode and the warning filters it reads are
    process-wide."""
    global _count_syncs
    _count_syncs = bool(on)


def reset_runtime_state() -> None:
    """Forget which programs were verified, the violation log and the sync
    counts (tests)."""
    with _SEEN_LOCK:
        _VERIFIED_SEEN.clear()
        del _VIOLATIONS[:]
        _SYNCS.clear()


def runtime_violations() -> List[Finding]:
    with _SEEN_LOCK:
        return list(_VIOLATIONS)


def runtime_syncs() -> Dict[str, Dict[str, int]]:
    """{family: {"file:line": synchronisations}} of the windows recorded
    under ``count_syncs``."""
    out: Dict[str, Dict[str, int]] = {}
    with _SEEN_LOCK:
        for (family, site), n in _SYNCS.items():
            out.setdefault(family, {})[site] = n
    return out


def _enabled(conf) -> bool:
    if conf is None:
        return _default_enabled
    return bool(conf.get(_CONF_KEY))


def _shape_signature(args) -> tuple:
    """The shapes of a program's arguments (tensors and arrays; the type of
    anything else), as the JAX package keys an executable."""
    return tuple(
        tuple(a.shape) if hasattr(a, "shape") else repr(type(a))
        for a in pytree.tree_leaves(args)
    )


class _Window:
    """Records the program run inside it, then verifies the record."""

    def __init__(self, family: str, key, seen_key):
        self.family = family
        self.key = key
        self.seen_key = seen_key
        self.record = ProgramRecord()
        self._stack = None
        self._caught = None

    def __enter__(self):
        from hyperspace_tpu_torch.parallel import mesh

        stack = contextlib.ExitStack()
        try:
            if _count_syncs and torch.cuda.is_available() and torch.cuda.is_initialized():
                # the mode is set outside the caught warnings: setting it can
                # warn once on its own
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
                stack.callback(torch.cuda.set_sync_debug_mode, prev)
                self._caught = stack.enter_context(warnings.catch_warnings(record=True))
                warnings.simplefilter("always")
            stack.enter_context(mesh.listening_collectives(self.record.collectives))
            stack.enter_context(_Recorder(self.record))
        except Exception as exc:  # a window that cannot record must say so
            stack.close()
            self._forget()
            warnings.warn(f"hscheck: could not record {self.family} program for verification: {exc}")
            return self
        self._stack = stack
        return self

    def _forget(self) -> None:
        with _SEEN_LOCK:
            _VERIFIED_SEEN.discard(self.seen_key)

    def __exit__(self, exc_type, exc, tb):
        if self._stack is None:
            return False
        self._stack.close()
        if exc_type is not None:
            # the program did not finish (an overflow re-run, an unsupported
            # shape): its record is partial, so the next call records anew
            self._forget()
            return False
        syncs = None
        if self._caught is not None:
            syncs = Counter()
            for w in self._caught:
                if "synchroniz" in str(w.message):
                    syncs[f"{'/'.join(w.filename.rsplit('/', 2)[-2:])}:{w.lineno}"] += 1
                else:
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        _verify_and_count(self.family, self.key, self.record, syncs)
        return False


def _verify_and_count(family: str, key, record: ProgramRecord, syncs: Optional[Counter]) -> None:
    findings = verify_program(family, record, program=str(key))
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_check_programs_verified_total",
        "Device programs verified against their declared program contract",
        program=family,
    ).inc()
    for f in findings:
        REGISTRY.counter(
            "hs_check_violations_total",
            "Program-contract and invariant violations detected by hscheck",
            rule=f.rule,
            program=family,
        ).inc()
        warnings.warn(f"hscheck program contract violation: {f.render()}")
    with _SEEN_LOCK:
        _VIOLATIONS.extend(findings)
        for site, n in (syncs or {}).items():
            _SYNCS[(family, site)] += n


_OFF = contextlib.nullcontext()


def maybe_verify(conf, family: str, key, args):
    """A window to run one device program in: with
    ``hyperspace.check.hlo.enabled`` (or the module default, for sites with
    no conf in reach) on, the first call per (program key, shape signature
    of ``args``) is recorded as it runs and verified against ``family``'s
    contract; every other call, and every call with the check off, runs
    unobserved. The program runs once either way. ``key`` may be a
    zero-argument callable, called only with the check on, so the disabled
    path stays one conf lookup.

    Violations are counted in ``hs_check_violations_total{rule,program}``,
    kept readable via :func:`runtime_violations`, and surfaced as a warning —
    never an exception: a production query must not die because a program
    changed shape; the metric is the alarm.
    """
    if not _enabled(conf):
        return _OFF
    if callable(key):
        key = key()
    seen_key = (key, _shape_signature(args))
    with _SEEN_LOCK:
        if seen_key in _VERIFIED_SEEN:
            return _OFF
        _VERIFIED_SEEN.add(seen_key)
    return _Window(family, key, seen_key)
