"""The port's device predicate compiler against the JAX package's.

The same host columns, made from a seed with numpy, are encoded by each
package's ``encode_column`` and evaluated by each package's
``compile_predicate``: the JAX program jitted on the CPU backend, the port's
torch program on torch CPU tensors with its literals uploaded through
``upload_literals``. Masks are boolean over exact int64/float64 compares, so
they must be equal; no tolerance applies. The edge cases are the ones torch
and JAX treat differently under x64 — integer true division, integer ``%``
by zero, literal promotion around 2^24 and 2^53 — plus NaN, -0.0, ±inf, NaT,
null string codes, absent string literals, ``IN`` and Kleene logic. Both
packages must also reject the same shapes with ``DeviceUnsupported`` and
print the same predicate skeletons.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from hyperspace_tpu.exec import device as RD  # noqa: E402
from hyperspace_tpu.plan import expr as RE  # noqa: E402
from hyperspace_tpu.utils.x64 import ensure_x64  # noqa: E402
from hyperspace_tpu_torch.exec import device as D  # noqa: E402
from hyperspace_tpu_torch.plan import expr as E  # noqa: E402

pytestmark = pytest.mark.torch_port

N = 4096
BIG = 2**53


def _columns(seed: int = 5):
    """Host columns with every edge the device encodings carry."""
    rng = np.random.default_rng(seed)
    i = rng.integers(-50, 50, N).astype(np.int64)
    i[:8] = [2**24 - 1, 2**24, 2**24 + 1, BIG - 1, BIG, BIG + 1, -BIG - 1, 2**62]
    z = rng.integers(-3, 4, N).astype(np.int64)  # divisors, with zeros
    z[:4] = [0, -1, 0, 1]
    f = np.round(rng.standard_normal(N) * 4, 1)
    f[rng.random(N) < 0.05] = np.nan
    f[rng.random(N) < 0.05] = -0.0
    f[rng.random(N) < 0.05] = 0.0
    f[:4] = [np.inf, -np.inf, np.nan, -0.0]
    d = np.datetime64("1996-01-01") + rng.integers(0, 900, N).astype("timedelta64[D]")
    d[rng.random(N) < 0.05] = np.datetime64("NaT")
    s = np.array([f"s{x}" for x in rng.integers(0, 40, N)], dtype=object)
    s[rng.random(N) < 0.05] = None
    b = rng.random(N) < 0.5
    return {"i": i, "z": z, "f": f, "d": d, "s": s, "b": b}


@pytest.fixture(scope="module")
def host():
    return _columns()


def _encoded(host_cols):
    """Both packages' encodings of the same host columns, checked equal."""
    ref_cols, ref_codecs, cols, codecs = {}, {}, {}, {}
    for name, arr in host_cols.items():
        r_enc, r_codec = RD.encode_column(arr)
        enc, codec = D.encode_column(arr)
        assert enc.dtype == r_enc.dtype and enc.tobytes() == r_enc.tobytes(), name
        assert codec.kind == r_codec.kind and codec.unit == r_codec.unit
        if codec.kind == "string":
            assert codec.uniques.tolist() == r_codec.uniques.tolist()
        ref_cols[name], ref_codecs[name] = jnp.asarray(r_enc), r_codec
        cols[name], codecs[name] = torch.from_numpy(np.ascontiguousarray(enc)), codec
    return ref_cols, ref_codecs, cols, codecs


def _masks(pred, host_cols, encoded=None):
    """(JAX mask, port mask) of ``pred`` — a function of a package's expr
    module — over ``host_cols``; either is the exception it raised."""
    ensure_x64()
    ref_cols, ref_codecs, cols, codecs = encoded or _encoded(host_cols)
    out = []
    for mod, compile_, run in (
        (RE, RD.compile_predicate, lambda fn, lits: np.asarray(jax.jit(fn)(ref_cols, lits))),
        (E, D.compile_predicate, lambda fn, lits: fn(cols, D.upload_literals(lits, torch.device("cpu"))).numpy()),
    ):
        expr = pred(mod)
        try:
            fn, lits = compile_(expr, ref_codecs if mod is RE else codecs)
        except (RD.DeviceUnsupported, D.DeviceUnsupported) as e:
            out.append(e)
            continue
        out.append(run(fn, lits))
    return out


def _c(m, name):
    return m.col(name)


PREDICATES = {
    # literal promotion around 2^24 and 2^53 (int64 against float literals)
    "int_lt_f2p24": lambda m: _c(m, "i") < 16777216.5,
    "int_gt_f2p24": lambda m: _c(m, "i") > 16777217.0,
    "int_eq_f2p53": lambda m: _c(m, "i") == 9007199254740993.0,
    "int_lt_f2p53": lambda m: _c(m, "i") < 9007199254740993.0,
    "int_eq_i2p53": lambda m: _c(m, "i") == BIG + 1,
    "int_ge_f32": lambda m: _c(m, "i") >= np.float32(16777217.0),
    "int_plus_f32": lambda m: (_c(m, "i") + np.float32(0.5)) > 16777216,
    # integer true division and remainder, zero divisors included
    "int_div_lit": lambda m: (_c(m, "i") / 2) < 10,
    "int_div_col": lambda m: (_c(m, "i") / _c(m, "z")) > 1.5,
    "int_div_col_nan": lambda m: ~((_c(m, "i") / _c(m, "z")) == 7.0),
    "int_mod_lit": lambda m: (_c(m, "i") % 7) == 3,
    "int_mod_neg": lambda m: (_c(m, "i") % -7) == -3,
    "int_mod_zero_lit": lambda m: (_c(m, "i") % 0) == 0,
    "int_mod_col": lambda m: (_c(m, "i") % _c(m, "z")) == 0,
    "float_mod": lambda m: (_c(m, "f") % 2.5) > 1.0,
    "float_mod_col": lambda m: (_c(m, "f") % _c(m, "z")) < 0.5,
    "arith_mix": lambda m: (_c(m, "i") * 3 + 1 - _c(m, "f")) > 10,
    "int_mul_big": lambda m: (_c(m, "i") * 2) < 0,
    # floats: NaN, -0.0, ±inf
    "f_gt_negzero": lambda m: _c(m, "f") > -0.0,
    "f_eq_zero": lambda m: _c(m, "f") == 0.0,
    "f_ne": lambda m: _c(m, "f") != 1.5,
    "f_le_inf": lambda m: _c(m, "f") <= np.inf,
    "f_gt_neginf": lambda m: _c(m, "f") > -np.inf,
    "f_lt_nan_lit": lambda m: _c(m, "f") < float("nan"),
    "lit_gt_col": lambda m: m.lit(0.5) > _c(m, "f"),
    "col_vs_col": lambda m: _c(m, "f") < _c(m, "i"),
    # dates and NaT, with a folded calendar interval
    "date_range": lambda m: (_c(m, "d") >= np.datetime64("1996-06-01"))
    & (_c(m, "d") < np.datetime64("1997-01-01")),
    "date_interval": lambda m: _c(m, "d") < m.lit(np.datetime64("1996-01-31")) + np.timedelta64(3, "M"),
    "date_ne": lambda m: _c(m, "d") != np.datetime64("1996-02-02"),
    # strings: null codes, present and absent literals
    "s_eq": lambda m: _c(m, "s") == "s17",
    "s_eq_absent": lambda m: _c(m, "s") == "s17x",
    "s_ne_absent": lambda m: _c(m, "s") != "zzz",
    "s_lt": lambda m: _c(m, "s") < "s3",
    "s_le_absent": lambda m: _c(m, "s") <= "s25x",
    "s_gt": lambda m: _c(m, "s") > "s8",
    "s_ge_low": lambda m: _c(m, "s") >= "a",
    "s_lit_left": lambda m: m.lit("s2") <= _c(m, "s"),
    # NULL tests and Kleene NOT / AND / OR over unknowns
    "isnull_s": lambda m: _c(m, "s").is_null(),
    "isnull_f": lambda m: _c(m, "f").is_null(),
    "isnull_d": lambda m: _c(m, "d").is_null(),
    "isnull_i": lambda m: _c(m, "i").is_null(),
    "not_null_cmp": lambda m: ~(_c(m, "s") == "s1"),
    "not_not": lambda m: ~~(_c(m, "f") > 0),
    "or_unknown": lambda m: (_c(m, "s") == "s1") | (_c(m, "f") > 0),
    "and_unknown": lambda m: (_c(m, "f") > 0) & ~(_c(m, "d") < np.datetime64("1996-08-01")),
    "not_or": lambda m: ~((_c(m, "s") < "s2") | (_c(m, "f") < 0)),
    "not_and": lambda m: ~((_c(m, "s") < "s2") & (_c(m, "f") < 0)),
    "bool_col": lambda m: _c(m, "b") == True,  # noqa: E712
    # IN lists
    "in_int": lambda m: _c(m, "i").isin(1, 2, 3, BIG + 1),
    "in_float": lambda m: _c(m, "f").isin(0.0, 1.5, -0.0),
    "in_str": lambda m: _c(m, "s").isin("s1", "s2", "nope"),
    "not_in_str": lambda m: ~_c(m, "s").isin("s1", "s2"),
    "in_date": lambda m: _c(m, "d").isin(np.datetime64("1996-01-05"), np.datetime64("1997-01-01")),
}

#: shapes both compilers must reject
UNSUPPORTED = {
    "string_arith": lambda m: (_c(m, "s") + 1) > 0,
    "string_vs_int": lambda m: _c(m, "s") == 5,
    "float_vs_string": lambda m: _c(m, "f") == "x",
    "date_vs_string": lambda m: _c(m, "d") == "1996-01-01",
    "string_col_vs_col": lambda m: _c(m, "s") == _c(m, "s"),
    "input_file_name": lambda m: m.input_file_name() == "x",
    "empty_in": lambda m: m.In(_c(m, "i"), []),
    "null_in_list": lambda m: _c(m, "i").isin(1, None),
    "nan_in_list": lambda m: _c(m, "f").isin(1.0, float("nan")),
    "mixed_in_string": lambda m: _c(m, "s").isin("s1", 2),
    "string_in_int": lambda m: _c(m, "i").isin(1, "2"),
    "in_non_column": lambda m: (_c(m, "i") + 1).isin(1, 2),
    "isnull_non_column": lambda m: (_c(m, "i") + 1).is_null(),
    "datetime_arith": lambda m: (_c(m, "d") - _c(m, "d")) > 0,
    "datetime_vs_col": lambda m: _c(m, "d") < _c(m, "i"),
    "timedelta_literal": lambda m: _c(m, "i") < np.timedelta64(3, "D"),
    "numeric_not_bool": lambda m: m.Not(_c(m, "i")),
}


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_mask_matches_jax(host, name):
    ref, got = _masks(PREDICATES[name], host)
    assert not isinstance(ref, Exception), ref
    assert not isinstance(got, Exception), got
    assert got.dtype == np.bool_ and got.shape == ref.shape == (N,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_same_shapes_rejected(host, name):
    ref, got = _masks(UNSUPPORTED[name], host)
    assert isinstance(ref, RD.DeviceUnsupported), f"the JAX compiler accepts {name}"
    assert isinstance(got, D.DeviceUnsupported), f"the port accepts {name}: {got!r}"


def test_host_evaluation_matches_jax(host):
    """The host numpy evaluation — the oracle the executor falls back to —
    gives the JAX package's host masks too. Where it raises (an ordering
    compare of a string column holding NULLs compares None with str), the
    JAX package's raises the same way."""
    for name, pred in PREDICATES.items():
        try:
            want = RE.as_bool_mask(pred(RE).eval(host))
        except TypeError:
            with pytest.raises(TypeError):
                pred(E).eval(host)
            continue
        np.testing.assert_array_equal(E.as_bool_mask(pred(E).eval(host)), want, err_msg=name)


def test_skeletons_match(host):
    _, ref_codecs, _, codecs = _encoded(host)
    for name, pred in {**PREDICATES, **UNSUPPORTED}.items():
        assert D.predicate_skeleton(pred(E), codecs) == RD.predicate_skeleton(pred(RE), ref_codecs), name


def test_literals_upload_once_with_their_dtypes():
    lits = (np.int64(BIG + 1), np.float64(-0.0), np.int32(-7), np.float32(0.1), np.bool_(True))
    got = D.upload_literals(lits, torch.device("cpu"))
    assert [t.dtype for t in got] == [torch.int64, torch.float64, torch.int32, torch.float32, torch.bool]
    assert all(t.dim() == 0 for t in got)
    for t, v in zip(got, lits):
        assert np.asarray(t.item(), dtype=v.dtype).tobytes() == np.asarray(v).tobytes()
    # one buffer: every slot is a view into the same storage
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1
    assert D.upload_literals((), torch.device("cpu")) == ()


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(
    values=st.lists(st.integers(-(2**63), 2**63 - 1), min_size=1, max_size=40),
    divisors=st.lists(st.integers(-5, 5) | st.integers(-(2**63), 2**63 - 1), min_size=1, max_size=40),
    threshold=st.floats(allow_nan=False, allow_subnormal=False, width=64) | st.integers(-(2**63), 2**63 - 1),
)
def test_int64_arithmetic_matches_jax(values, divisors, threshold):
    """Random int64 values and divisors (zeros, -1, INT64_MIN included)
    through ``/``, ``%`` and compares against int or float thresholds."""
    n = max(len(values), len(divisors))
    host = {
        "i": np.resize(np.asarray(values, dtype=np.int64), n),
        "z": np.resize(np.asarray(divisors, dtype=np.int64), n),
    }
    enc = _encoded(host)
    for pred in (
        lambda m: (_c(m, "i") / _c(m, "z")) < threshold,
        lambda m: (_c(m, "i") % _c(m, "z")) >= threshold,
        lambda m: _c(m, "i") <= threshold,
        lambda m: (_c(m, "i") - _c(m, "z")) != threshold,
    ):
        ref, got = _masks(pred, host, enc)
        np.testing.assert_array_equal(got, ref)


# XLA's CPU backend flushes subnormal floats to zero (0.0 == 2e-308 is true
# there); the port, like numpy, compares them exactly, so they stay out
_FLOATS = st.floats(width=64, allow_subnormal=False)


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(
    values=st.lists(_FLOATS | st.sampled_from([0.0, -0.0, np.inf, -np.inf, np.nan]), min_size=1, max_size=40),
    lit=_FLOATS,
    op=st.sampled_from(["=", "!=", "<", "<=", ">", ">="]),
)
def test_float64_compares_match_jax(values, lit, op):
    host = {"f": np.asarray(values, dtype=np.float64)}
    enc = _encoded(host)
    for pred in (
        lambda m: m.BinaryOp(op, _c(m, "f"), m.lit(lit)),
        lambda m: ~m.BinaryOp(op, _c(m, "f") % 3.0, m.lit(lit)),
    ):
        ref, got = _masks(pred, host, enc)
        np.testing.assert_array_equal(got, ref)
