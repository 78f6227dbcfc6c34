"""Run a JAX-package test module's cases against the port, each query also
held against the JAX package.

``load_cases`` reads a test module of the JAX package (``tests/test_sql.py``
and the like), rewrites ``hyperspace_tpu`` to ``hyperspace_tpu_torch`` in its
text and executes it as a module of its own, so each case drives the port
with the case's own assertions. Its ``session`` fixture is replaced by a
``MirroredSession``: a port session (``device="cpu"``) paired with a JAX
package session over the same lake and the same index system path (either
package serves the other's indexes). While ``mirroring`` is active:

- ``Session.sql`` runs the text through both packages: the same error type
  and message when the port raises, else the same unoptimized plan text;
- ``DataFrame.optimized_plan`` gives the same text in both packages, and
  so do ``Hyperspace.explain`` and ``Hyperspace.why_not``;
- ``DataFrame.collect`` gives the same column names and rows in both, in
  the same order; floats at rtol 1e-9; the same error type when the port
  raises; with ``compare_traces``, the same dispatch trace, ``decode:``
  lines included (both packages decode natively, each with its own build
  of the same library).

A DataFrame built with the port's API is carried to the JAX package by
rebuilding its plan, node for node and expression for expression, from the
same-named classes there (the plan and expression modules are verbatim
copies); the source relations map to the JAX package's reads of the same
paths.
"""

import contextlib
import importlib
import math
import re
import sys
import types

import numpy as np
import pytest

import hyperspace_tpu as hst
import hyperspace_tpu_torch as ht
from hyperspace_tpu_torch.plan.dataframe import DataFrame as PortFrame

FLOAT_RTOL = 1e-9


class MirroredSession(ht.Session):
    def __init__(self, system_path: str, conf=None, compare_traces: bool = False):
        conf = {**(conf or {}), ht.keys.SYSTEM_PATH: system_path}
        super().__init__(conf=conf, device="cpu")
        self.mirror = hst.Session(conf=dict(conf))
        self.compare_traces = compare_traces
        self._relations = {}  # id(port relation) -> (port relation, JAX relation)

    # -- the JAX side ---------------------------------------------------------
    def sync_mirror(self) -> None:
        """The JAX session takes the port session's conf and toggle, and
        re-reads the index roster (the port may have just changed it)."""
        self.mirror.conf._conf = dict(self.conf._conf)
        self.mirror.hyperspace_enabled = self.hyperspace_enabled
        self.mirror.index_manager.clear_cache()

    def ref_frame(self, df):
        self.sync_mirror()
        got = getattr(df, "_ref_frame", None)
        if got is not None:
            return got
        return hst.DataFrame(to_ref(df.plan, self, {}), self.mirror)

    # -- the port side --------------------------------------------------------
    def read(self, paths, file_format: str, **options):
        df = super().read(paths, file_format, **options)
        ref = self.mirror.read(paths, file_format, **options)
        self._relations[id(df.plan.relation)] = (df.plan.relation, ref.plan.relation)
        return df

    def register_view(self, name, df) -> None:
        super().register_view(name, df)
        self.mirror.register_view(name, self.ref_frame(df))

    def drop_view(self, name) -> None:
        super().drop_view(name)
        self.mirror.drop_view(name)

    def sql(self, query: str):
        self.sync_mirror()
        try:
            df = super().sql(query)
        except Exception as e:
            with pytest.raises(Exception) as ref_err:
                self.mirror.sql(query)
            assert type(ref_err.value).__name__ == type(e).__name__, (query, e, ref_err.value)
            assert str(ref_err.value) == str(e), query
            raise
        ref = self.mirror.sql(query)
        assert df.plan.pretty() == ref.plan.pretty(), query
        df._ref_frame = ref
        return df


_REF_MODULES = {}


def _ref_class(cls):
    mod = cls.__module__
    if not mod.startswith("hyperspace_tpu_torch."):
        return None
    ref_mod = _REF_MODULES.get(mod)
    if ref_mod is None:
        ref_mod = _REF_MODULES[mod] = importlib.import_module("hyperspace_tpu" + mod[len("hyperspace_tpu_torch"):])
    return getattr(ref_mod, cls.__name__)


def to_ref(obj, sess: MirroredSession, memo: dict):
    """The JAX package's twin of a port plan or expression (sharing kept:
    one object maps to one object)."""
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, ht.Session):
        return sess.mirror
    if key in sess._relations:
        return sess._relations[key][1]
    if isinstance(obj, list):
        out = [to_ref(x, sess, memo) for x in obj]
    elif isinstance(obj, tuple):
        out = tuple(to_ref(x, sess, memo) for x in obj)
    elif isinstance(obj, dict):
        out = {k: to_ref(v, sess, memo) for k, v in obj.items()}
    else:
        cls = _ref_class(type(obj))
        if cls is None:
            return obj
        out = object.__new__(cls)
        memo[key] = out
        out.__dict__.update({k: to_ref(v, sess, memo) for k, v in vars(obj).items()})
        return out
    memo[key] = out
    return out


def index_scans(q):
    """The port's ``conftest.index_scans``: IndexScan nodes of the optimized
    plan."""
    from hyperspace_tpu_torch.plan import logical as PL

    return [p for p in PL.collect(q.optimized_plan(), lambda x: True) if isinstance(p, PL.IndexScan)]


def trace_lines(events) -> list:
    """A dispatch trace's summary lines."""
    from hyperspace_tpu_torch.exec import trace as T

    return T.summarize(events).splitlines()


def _rows(batch):
    cols = [np.asarray(batch[k]).tolist() for k in batch]
    return list(zip(*cols)) if cols else []


def same_rows(got, want, what) -> None:
    """The same column names and the same rows in the same order (floats
    at rtol 1e-9, NaN equal to NaN)."""
    assert list(got) == list(want), (what, list(got), list(want))
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert (x != x and y != y) or math.isclose(x, y, rel_tol=FLOAT_RTOL, abs_tol=0.0) or x == y, (
                    what, a, b)
            else:
                assert x == y or (x is None and y is None) or (x != x and y != y), (what, a, b)


@contextlib.contextmanager
def mirroring():
    """Hold every port query of a MirroredSession against the JAX package
    for the duration of the block."""
    orig_collect, orig_optimized = PortFrame.collect, PortFrame.optimized_plan
    busy = []  # re-entrancy guard: a port query inside a port query

    def optimized_plan(self):
        plan = orig_optimized(self)
        sess = self.session
        if isinstance(sess, MirroredSession) and not busy:
            busy.append(1)
            try:
                ref = sess.ref_frame(self).optimized_plan()
            finally:
                busy.pop()
            assert plan.pretty() == ref.pretty(), (plan.pretty(), ref.pretty())
        return plan

    def collect(self):
        sess = self.session
        if not isinstance(sess, MirroredSession) or busy:
            return orig_collect(self)
        busy.append(1)
        try:
            from hyperspace_tpu.exec import trace as ref_trace
            from hyperspace_tpu_torch.exec import trace as port_trace

            outer_events = port_trace._events  # a recording of the case's own
            try:
                with port_trace.recording() as got_events:
                    got = orig_collect(self)
            except Exception as e:
                with pytest.raises(Exception) as ref_err:
                    sess.ref_frame(self).collect()
                assert type(ref_err.value).__name__ == type(e).__name__, (e, ref_err.value)
                raise
            ref = sess.ref_frame(self)
            assert orig_optimized(self).pretty() == ref.optimized_plan().pretty()
            with ref_trace.recording() as ref_events:
                want = ref.collect()
            same_rows(got, want, self.plan.describe())
            if outer_events is not None:
                outer_events.extend(got_events)
            sess.last_trace_lines = trace_lines(got_events)
            if sess.compare_traces:
                assert trace_lines(got_events) == trace_lines(ref_events), (
                    self.plan.describe(), trace_lines(got_events), trace_lines(ref_events))
            return got
        finally:
            busy.pop()

    orig_explain, orig_why_not = ht.Hyperspace.explain, ht.Hyperspace.why_not

    def explain(self, df, verbose: bool = False, mode: str = "plaintext") -> str:
        got = orig_explain(self, df, verbose, mode)
        sess = self.session
        if isinstance(sess, MirroredSession):
            want = hst.Hyperspace(sess.mirror).explain(sess.ref_frame(df), verbose, mode)
            assert got == want, (got, want)
        return got

    def why_not(self, df, index_name=None, extended: bool = False) -> str:
        got = orig_why_not(self, df, index_name, extended)
        sess = self.session
        if isinstance(sess, MirroredSession):
            want = hst.Hyperspace(sess.mirror).why_not(sess.ref_frame(df), index_name, extended)
            assert got == want, (got, want)
        return got

    PortFrame.collect, PortFrame.optimized_plan = collect, optimized_plan
    ht.Hyperspace.explain, ht.Hyperspace.why_not = explain, why_not
    try:
        yield
    finally:
        PortFrame.collect, PortFrame.optimized_plan = orig_collect, orig_optimized
        ht.Hyperspace.explain, ht.Hyperspace.why_not = orig_explain, orig_why_not


class CpuSession(ht.Session):
    """A port session on the CPU unless the caller names a device."""

    def __init__(self, conf=None, device="cpu"):
        super().__init__(conf=conf, device=device)


def cpu_port():
    """The port's package as a JAX suite imports it (``hst``), with
    ``Session`` defaulting to the CPU, so the suite's own
    ``hst.Session(conf=...)`` calls build CPU sessions."""
    mod = types.ModuleType("hyperspace_tpu_torch")
    mod.__dict__.update(vars(ht))
    mod.Session = CpuSession
    return mod


#: the ``load_cases`` rewrite that gives a suite ``cpu_port()`` as ``hst``
CPU_PORT_IMPORT = {
    "import hyperspace_tpu_torch as hst\n": "import torch_mirror as _mirror\nhst = _mirror.cpu_port()\n",
}


def port_tpch_env(root):
    """``tests/test_tpch_queries.py::build_tpch_env`` with the port's CPU
    session: the same shaped 8-table lake and index roster."""
    name = "_torch_tpch_queries_env"
    mod = sys.modules.get(name)
    if mod is None:
        import os

        mod = load_cases(os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_tpch_queries.py"),
                         name, rewrites=CPU_PORT_IMPORT)
    return mod.build_tpch_env(root)


def mirrored_session(conf=None, **kwargs) -> MirroredSession:
    """A ``MirroredSession`` built the way the JAX suites build a session:
    ``Session(conf={SYSTEM_PATH: ..., ...})``."""
    conf = dict(conf or {})
    return MirroredSession(conf.pop(ht.keys.SYSTEM_PATH), conf=conf, **kwargs)


def load_cases(path: str, name: str, rewrites=None):
    """Execute the JAX test module at ``path`` with the package renamed to
    the port (and each ``rewrites`` line replaced) as module ``name``."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    text = re.sub(r"\bhyperspace_tpu\b", "hyperspace_tpu_torch", text)
    for old, new in (rewrites or {}).items():
        assert old in text, old
        text = text.replace(old, new)
    mod = types.ModuleType(name)
    mod.__file__ = path
    mod.__rewritten__ = text
    sys.modules[name] = mod
    exec(compile(text, path, "exec"), mod.__dict__)
    return mod


def export_cases(mod, namespace: dict, left_out: dict) -> None:
    """Put ``mod``'s fixtures, test functions and test classes (as
    subclasses, less the ``left_out`` methods) into a test module's
    namespace, where pytest collects them; a class named in ``left_out``
    stays out whole."""
    for attr, obj in vars(mod).items():
        if hasattr(obj, "_pytestfixturefunction") or type(obj).__name__ == "FixtureFunctionDefinition":
            namespace[attr] = obj
        elif attr.startswith("test_") and callable(obj) and attr not in left_out:
            namespace[attr] = obj
        elif attr.startswith("Test") and isinstance(obj, type) and attr not in left_out:
            gone = {m.split("::")[1]: None for m in left_out if m.startswith(attr + "::")}
            namespace[attr] = type(attr, (obj,), {"__module__": namespace["__name__"], **gone})


def assert_every_case(mods, namespace: dict, left_out: dict) -> None:
    """Each test function and test method of ``mods`` (modules from
    ``load_cases``) is collected in ``namespace`` or left out by name, never
    both."""
    import ast

    for mod in mods:
        tree = ast.parse(mod.__rewritten__)
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
                assert (node.name in namespace) != (node.name in left_out), node.name
            elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
                for fn in node.body:
                    if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_"):
                        name = f"{node.name}::{fn.name}"
                        ran = getattr(namespace.get(node.name), fn.name, None) is not None
                        assert ran != (name in left_out or node.name in left_out), name


def cases_of(mod) -> list:
    """Every case name of a module from ``load_cases``: ``test_x`` and
    ``TestX::test_y``."""
    import ast

    tree = ast.parse(mod.__rewritten__)
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out += [f"{node.name}::{fn.name}" for fn in node.body
                    if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")]
    return out


class ModuleUnion:
    """One name space over several port modules, for a JAX suite that reads
    internals the port keeps in other modules than the JAX package does
    (``exec/device.py``'s join internals live in ``exec/join.py``, its
    aggregate's in ``exec/aggregate.py``): an attribute is read from the
    first module that has it, and set (``monkeypatch.setattr``) on that
    module, where the port's callers look it up."""

    def __init__(self, *module_names: str):
        object.__setattr__(self, "_modules", [importlib.import_module(m) for m in module_names])

    def _owner(self, name: str):
        for mod in self._modules:
            if hasattr(mod, name):
                return mod
        raise AttributeError(name)

    def __getattr__(self, name: str):
        return getattr(self._owner(name), name)

    def __setattr__(self, name: str, value) -> None:
        setattr(self._owner(name), name, value)


class _Series:
    def __init__(self, read):
        self._read = read

    @property
    def value(self):
        return self._read()


class PortRegistry:
    """The JAX package's metrics registry (``obs/metrics.REGISTRY``) read
    from the port's own counters, for suites whose series the port keeps
    outside its registry (``obs/metrics.py``, which counts dispatches, IO
    errors, faults and native decode under the JAX package's names):

    - ``hs_device_dispatches_total{program}``: ``exec/device.dispatches``;
    - ``hs_device_fallback_total{op, reason}``: ``exec/trace.fallbacks``;
    - ``hs_xla_compiles_total``: programs built by ``exec/stage_ir.compile_stage``
      (the port's eager programs compile nothing else);
    - the ``hs_device_peak_bytes`` gauge: ``exec/stage_ir.peak_bytes()``.

    Any other counter is the port's registry's own; any other gauge raises,
    so a case that reads one is left out by name."""

    def _dispatches(self):
        from hyperspace_tpu_torch.exec import device

        return device.dispatches

    def counter(self, name: str, help: str = "", **labels):
        from hyperspace_tpu_torch.exec import stage_ir, trace

        if name == "hs_device_dispatches_total":
            return _Series(lambda: float(self._dispatches()[labels["program"]]))
        if name == "hs_device_fallback_total":
            return _Series(lambda: float(trace.fallbacks[(labels["op"], labels["reason"])]))
        if name == "hs_xla_compiles_total":
            assert not labels, labels
            return _Series(lambda: float(stage_ir.stage_compiles))
        from hyperspace_tpu_torch.obs.metrics import REGISTRY

        return REGISTRY.counter(name, help, **labels)

    def gauge(self, name: str, help: str = "", **labels):
        from hyperspace_tpu_torch.exec import stage_ir

        if name == "hs_device_peak_bytes":
            return _Series(lambda: float(stage_ir.peak_bytes()))
        raise KeyError(f"the port has no gauge {name!r} (A9)")

    def snapshot(self) -> dict:
        from hyperspace_tpu_torch.exec import stage_ir, trace

        out = {}
        if self._dispatches():
            out["hs_device_dispatches_total"] = {"series": [
                {"labels": {"program": p}, "value": float(v)} for p, v in self._dispatches().items()]}
        if trace.fallbacks:
            out["hs_device_fallback_total"] = {"series": [
                {"labels": {"op": op, "reason": r}, "value": float(v)} for (op, r), v in trace.fallbacks.items()]}
        if stage_ir.stage_compiles:
            out["hs_xla_compiles_total"] = {"series": [{"labels": {}, "value": float(stage_ir.stage_compiles)}]}
        return out


PORT_REGISTRY = PortRegistry()


_CPU_CHILD_SESSION = (
    "\n\n"
    "class _CpuSession(hst.Session):  # the port's session, on the CPU\n"
    "    def __init__(self, conf=None, device=\"cpu\"):\n"
    "        super().__init__(conf=conf, device=device)\n"
    "\n"
    "\n"
    "hst.Session = _CpuSession\n"
)


def port_child_script(text: str) -> str:
    """A JAX suite's child-process script as the port's: the package
    renamed, JAX's platform pinning (and the comment above it) gone, and
    ``hst.Session`` a CPU session, so that the child imports neither
    ``jax`` nor ``hyperspace_tpu``."""
    text = re.sub(r"\bhyperspace_tpu\b", "hyperspace_tpu_torch", text)
    out = []
    for line in text.splitlines(keepends=True):
        if re.search(r"jax|JAX", line):
            while out and out[-1].lstrip().startswith("#"):
                out.pop()
            continue
        out.append(line)
        if line == "import hyperspace_tpu_torch as hst\n":
            out.append(_CPU_CHILD_SESSION)
    return "".join(out)


def child_scripts(path: str) -> dict:
    """The child-process scripts of the JAX suite at ``path`` (its
    module-level string constants that import ``hyperspace_tpu``), each as
    the port's (``port_child_script``): name -> text."""
    import ast

    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)
                and "import hyperspace_tpu" in node.value.value):
            out[node.targets[0].id] = port_child_script(node.value.value)
    return out


class _PortJax:
    """The few ``jax`` names a JAX mesh suite calls, over the port's mesh
    (``port_jax_shim``): ``devices()`` lists the CPU mesh's shards and
    ``device_put(array, placement)`` places a host array with a
    ``parallel.mesh`` placement."""

    @staticmethod
    def devices():
        from hyperspace_tpu_torch.parallel import mesh

        return mesh.make_mesh(device_type="cpu").devices.tolist()

    @staticmethod
    def device_put(array, placement):
        return placement.put(array)


def port_jax_shim() -> _PortJax:
    """A suite's ``jax`` module, for suites whose arrays go through
    ``device_put`` and come back through ``np.asarray`` (the port's
    ``ShardedTensor`` reads as numpy, so ``jnp`` can be numpy)."""
    return _PortJax()
