"""The port's scale-out serving fabric, held to the JAX package's suite and
to the JAX package itself.

tests/test_fabric.py runs with the package renamed to the port
(tests/torch_mirror.py ``load_cases``), its sessions the port's on the CPU
(``torch_mirror.cpu_port``): commit records, the invalidation bus's
persistence and Lamport merge, the commit watcher, the coherence sidecar,
the torn-pin seqlock, the FrontDoor and its worker endpoints over HTTP on
loopback, the fenced refresh lease, health tracking, failover and hedging,
and fsck. Its child-process scripts are the port's
(``torch_mirror.child_scripts``: they import neither ``jax`` nor
``hyperspace_tpu``); the three that run them are marked slow, as in the
JAX package, and tier-1 does not run them.

The cases at the end hold the port against the JAX package: C9's commit
records (the same record files with the same ``commit_seq``, and both
packages purge their caches), ``rendezvous_pick`` and ``rendezvous_order``
over 1 000 keys, ``merge_prometheus_texts``, fsck's report and removals on
the same damaged lake, and lake artifacts that cross between the packages:
a commit record one package writes is replayed by the other's watcher, and
a lease one package holds fences the other's ``write_log``. Tolerance:
exact everywhere.
"""

import datetime
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hyperspace_tpu as hst  # noqa: E402
import hyperspace_tpu_torch as ht  # noqa: E402
import torch_mirror as M  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.fabric]

HERE = os.path.dirname(__file__)
SOURCES = {"test_fabric.py": dict(M.CPU_PORT_IMPORT)}
LEFT_OUT = {}

_modules = [M.load_cases(os.path.join(HERE, src), f"_torch_{src[:-3]}_suite", rewrites=rw)
            for src, rw in SOURCES.items()]
for _src, _mod in zip(SOURCES, _modules):
    for _name, _text in M.child_scripts(os.path.join(HERE, _src)).items():
        setattr(_mod, _name, _text)
    M.export_cases(_mod, globals(), LEFT_OUT)


@pytest.fixture()
def session(tmp_system_path):
    """The suite's session: the port's, on the CPU."""
    sess = ht.Session(conf={ht.keys.SYSTEM_PATH: tmp_system_path}, device="cpu")
    ht.set_session(sess)
    yield sess
    ht.set_session(None)


@pytest.fixture(autouse=True)
def _no_session_left():
    yield
    ht.set_session(None)
    hst.set_session(None)


def test_every_case_is_run_or_listed():
    M.assert_every_case(_modules, globals(), LEFT_OUT)


# -- the port against the JAX package ------------------------------------------

PACKAGES = {"hyperspace_tpu": hst, "hyperspace_tpu_torch": ht}


def _module(pkg: str, name: str):
    from importlib import import_module

    return import_module(f"{pkg}.{name}")


def _session(pkg: str, system_path: str, node: str, **extra):
    mod = PACKAGES[pkg]
    conf = {
        mod.keys.SYSTEM_PATH: system_path,
        mod.keys.FABRIC_ENABLED: True,
        mod.keys.FABRIC_NODE_ID: node,
        mod.keys.FABRIC_WATCHER_ENABLED: False,
        mod.keys.FABRIC_SLO_PUBLISH_INTERVAL_SECONDS: 3600,
        mod.keys.NUM_BUCKETS: 4,
        **extra,
    }
    return mod.Session(conf=conf, device="cpu") if mod is ht else mod.Session(conf=conf)


def _lake_file(root, i: int = 0) -> str:
    """``part-0000i.parquet`` under ``root``: 600 seeded rows of (k, v)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(9 + i)
    pq.write_table(pa.table({"k": rng.integers(0, 40, 600).astype(np.int64),
                             "v": np.round(rng.uniform(0, 10, 600), 3)}),
                   os.path.join(root, f"part-{i:05d}.parquet"))
    return str(root)


def _records(system_path: str, index: str) -> list:
    from hyperspace_tpu_torch.fabric import records

    return records.read_commit_records(records.commits_dir(system_path, index))


def test_commit_records_and_purges_equal_the_jax_package(tmp_path):
    """C9: with the fabric on, ``create_index`` and an incremental refresh
    of a 1-file lake write the same commit records in both packages (the
    same record ids, ``seq``, origin, kind, log id; as many affected files,
    each under its own system path), leave the same ``commit_seq``, and
    purge the caches in both: the refresh's commit clears the roster (each
    package's ``hs_lifecycle_invalidations_total{cache="roster"}``; the byte
    caches' counts follow what each package happened to cache), and each
    subscriber sees both commits."""
    seen = {}
    for pkg, mod in PACKAGES.items():
        lake = _lake_file(tmp_path / pkg / "lake")
        sp = str(tmp_path / pkg / "indexes")
        sess = _session(pkg, sp, "nC9")
        events = seen[pkg] = []
        sess.lifecycle_bus.subscribe(lambda e, out=events: out.append((e.kind, e.index_name, e.log_id)))
        df = sess.read_parquet(lake)
        mod.Hyperspace(sess).create_index(df, mod.CoveringIndexConfig("c9", ["k"], ["v"]))
        sess.enable_hyperspace()
        assert len(df.filter(mod.col("k") == 3).select("v").collect()["v"]) > 0
        reg = _module(pkg, "obs.metrics").REGISTRY
        purged = lambda: {c: reg.counter("hs_lifecycle_invalidations_total", cache=c).value  # noqa: E731
                          for c in ("roster", "bucket", "io", "device")}
        before = purged()
        _lake_file(lake, 1)
        mod.Hyperspace(sess).refresh_index("c9", "incremental")
        seen[pkg + ":purged"] = {c: v - before[c] for c, v in purged().items()}
        assert seen[pkg + ":purged"]["roster"] == 1, pkg
        assert sess.lifecycle_bus.commit_seq == 2
        seen[pkg + ":records"] = _records(sp, "c9")
        sess.fabric.stop()
    assert seen["hyperspace_tpu"] == seen["hyperspace_tpu_torch"]
    assert [e[0] for e in seen["hyperspace_tpu"]] == ["create", "refresh-incremental"]

    def shape(recs, sp):
        out = []
        for rid, rec in recs:
            assert all(f.startswith(sp) for f in rec["affectedFiles"]), rec
            out.append((rid, rec["seq"], rec["origin"], rec["index"], rec["kind"], rec["logId"],
                        len(rec["affectedFiles"])))
        return out

    ref = shape(seen["hyperspace_tpu:records"], str(tmp_path / "hyperspace_tpu" / "indexes"))
    port = shape(seen["hyperspace_tpu_torch:records"], str(tmp_path / "hyperspace_tpu_torch" / "indexes"))
    assert port == ref and [r[1] for r in ref] == [1, 2]


def test_rendezvous_pick_and_order_equal_the_jax_package():
    """Over 1 000 tenant keys and memberships of 1 to 7 workers (shuffled),
    both packages pick the same worker and give the same failover order."""
    from hyperspace_tpu.fabric import frontdoor as RF
    from hyperspace_tpu_torch.fabric import frontdoor as PF

    rng = np.random.default_rng(16)
    workers = [f"http://127.0.0.1:{8000 + i}" for i in range(7)]
    for i in range(1000):
        key = f"tenant-{int(rng.integers(0, 10**9))}-{i}"
        nodes = list(rng.permutation(workers)[: 1 + i % 7])
        assert PF.rendezvous_pick(key, nodes) == RF.rendezvous_pick(key, nodes)
        assert PF.rendezvous_order(key, nodes) == RF.rendezvous_order(key, nodes)


def test_merge_prometheus_texts_equals_the_jax_package(tmp_path):
    """Two served expositions (one ``QueryServer`` of each package, each
    with its own ``server`` label, after one query) and a synthetic one
    with a family the others lack merge to the same text in both
    packages."""
    from hyperspace_tpu.fabric.frontdoor import merge_prometheus_texts as ref_merge
    from hyperspace_tpu_torch.fabric.frontdoor import merge_prometheus_texts as port_merge

    lake = _lake_file(tmp_path / "lake")
    texts = []
    for pkg, mod in PACKAGES.items():
        sess = mod.Session(conf={mod.keys.SYSTEM_PATH: str(tmp_path / pkg)}, **(
            {"device": "cpu"} if mod is ht else {}))
        sess.register_view("t", sess.read_parquet(lake))
        with _module(pkg, "serving").QueryServer(sess, workers=1, name=f"qs{len(texts)}") as srv:
            srv.query("SELECT v FROM t WHERE k = 3")
            texts.append(srv.prometheus_text())
    texts.append("# HELP hs_extra_total extra\n# TYPE hs_extra_total counter\n"
                 'hs_extra_total{server="qs9"} 4\n')
    for order in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        chosen = [texts[i] for i in order]
        assert port_merge(chosen) == ref_merge(chosen)


def _damaged_lake(sp: str, pkg: str) -> None:
    """Commit records (one torn, old ones), a lease with a takeover history
    and node ledgers, written by ``pkg``'s own fabric modules at fixed
    clocks."""
    records = _module(pkg, "fabric.records")
    lease = _module(pkg, "fabric.lease")
    CommitEvent = _module(pkg, "lifecycle.invalidation").CommitEvent
    for index in ("gcA", "gcB"):
        ev = CommitEvent(index, 1, "create", origin="n1")
        for seq in range(5):
            records.append_commit_record(sp, ev, seq=seq)
    with open(os.path.join(records.commits_dir(sp, "gcA"), f"{2:010d}"), "w") as f:
        f.write("torn {")

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clk = Clock()
    lease.acquire(sp, "refresh/gcA", "n1", ttl_s=10.0, clock=clk)
    clk.t = 120.0
    lease.acquire(sp, "refresh/gcA", "n2", ttl_s=10.0, clock=clk)
    lease.acquire(sp, "refresh/gcB", "n1", ttl_s=10.0, clock=clk)
    for node in ("nFresh", "nDead"):
        records.write_node_file(sp, node, {})
    path = os.path.join(records.nodes_dir(sp), "nDead.json")
    with open(path) as f:
        state = json.load(f)
    state["updatedAt"] = 0.0
    with open(path, "w") as f:
        json.dump(state, f)


def _tree(root: str) -> list:
    out = []
    for dirpath, _, names in os.walk(root):
        out.extend(os.path.relpath(os.path.join(dirpath, n), root) for n in names)
    return sorted(out)


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("dry_run", [False, True])
def test_fsck_reports_and_removes_what_the_jax_package_does(tmp_path, writer, dry_run):
    """One damaged lake (written by either package), copied: each
    package's fsck at the same clock gives the same report and leaves the
    same files, in a dry run and a real one."""
    from hyperspace_tpu.fabric.fsck import fsck as ref_fsck
    from hyperspace_tpu_torch.fabric.fsck import fsck as port_fsck

    base = str(tmp_path / "lake")
    _damaged_lake(base, writer)
    ref_sp, port_sp = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(base, ref_sp)
    shutil.copytree(base, port_sp)
    now = 1.0e10  # every record is old, the lease expired, one node is dead
    for retention in (3600.0, 1.0e11):
        want = ref_fsck(ref_sp, retention_s=retention, dead_node_s=1.0e9, dry_run=dry_run, clock=lambda: now)
        got = port_fsck(port_sp, retention_s=retention, dead_node_s=1.0e9, dry_run=dry_run, clock=lambda: now)
        want["systemPath"] = got["systemPath"] = "<lake>"
        assert got == want
        assert _tree(port_sp) == _tree(ref_sp)
    assert (_tree(port_sp) == _tree(base)) == dry_run


@pytest.mark.parametrize("writer,reader", [("hyperspace_tpu", "hyperspace_tpu_torch"),
                                           ("hyperspace_tpu_torch", "hyperspace_tpu")])
def test_commit_records_replay_across_the_packages(tmp_path, writer, reader):
    """A commit record one package writes (create, then an incremental
    refresh) is replayed by the other package's watcher: its bus takes the
    writer's ``commit_seq``, its subscribers see the writer's commits with
    the writer's node as origin, and its snapshot pins the version the
    writer committed."""
    lake = _lake_file(tmp_path / "lake")
    sp = str(tmp_path / "indexes")
    w = _session(writer, sp, "nW")
    wmod = PACKAGES[writer]
    wmod.Hyperspace(w).create_index(w.read_parquet(lake), wmod.CoveringIndexConfig("x", ["k"], ["v"]))
    r = _session(reader, sp, "nR")
    seen = []
    r.lifecycle_bus.subscribe(lambda e: seen.append((e.kind, e.index_name, e.origin)))
    assert r.fabric.watcher.poll_once() == 1
    assert r.lifecycle_bus.commit_seq == 1
    snapshot = _module(reader, "lifecycle").SnapshotHandle
    v1 = snapshot.capture(r).index_version("x")
    _lake_file(lake, 1)
    wmod.Hyperspace(w).refresh_index("x", "incremental")
    assert r.fabric.watcher.poll_once() == 1
    assert r.lifecycle_bus.commit_seq == w.lifecycle_bus.commit_seq == 2
    assert seen == [("create", "x", "nW"), ("refresh-incremental", "x", "nW")]
    v2 = snapshot.capture(r).index_version("x")
    assert v2 != v1 and v2 == _module(writer, "lifecycle").SnapshotHandle.capture(w).index_version("x")
    assert r.fabric.watcher.poll_once() == 0  # nothing replays twice
    r.fabric.stop()
    w.fabric.stop()


@pytest.mark.parametrize("holder,zombie", [("hyperspace_tpu", "hyperspace_tpu_torch"),
                                           ("hyperspace_tpu_torch", "hyperspace_tpu")])
def test_a_lease_of_one_package_fences_the_other(tmp_path, holder, zombie):
    """The zombie's package holds a lease that expired; the holder's
    package takes it over on the lake. The zombie's ``write_log`` under its
    ``fence_scope`` raises its package's ``LeaseLostError`` (held token 1,
    lake token 2) and lands no entry; the holder's ``write_log`` under its
    own scope lands one."""
    lake = _lake_file(tmp_path / "lake")
    sp = str(tmp_path / "indexes")
    s = _session(holder, sp, "nH")
    hmod = PACKAGES[holder]
    hmod.Hyperspace(s).create_index(s.read_parquet(lake), hmod.CoveringIndexConfig("f", ["k"], ["v"]))
    s.fabric.stop()

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clk = Clock()
    zlease = _module(zombie, "fabric.lease")
    hlease = _module(holder, "fabric.lease")
    old = zlease.acquire(sp, "refresh/f", "nZ", ttl_s=10.0, clock=clk)
    clk.t = 111.0  # the zombie stopped renewing
    new = hlease.acquire(sp, "refresh/f", "nH", ttl_s=10.0, clock=clk)
    assert (old.token, new.token) == (1, 2)
    index_dir = os.path.join(sp, "f")
    zlog = _module(zombie, "models.log_manager").IndexLogManager(index_dir)
    hlog = _module(holder, "models.log_manager").IndexLogManager(index_dir)
    latest = zlog.get_latest_id()
    entry = zlog.get_latest_log()
    with zlease.fence_scope(old):
        with pytest.raises(zlease.LeaseLostError) as err:
            zlog.write_log(latest + 1, entry)
    assert (err.value.held_token, err.value.current_token) == (1, 2)
    assert zlog.get_latest_id() == hlog.get_latest_id() == latest  # nothing landed
    with hlease.fence_scope(new):
        assert hlog.write_log(latest + 1, hlog.get_latest_log())
    assert zlog.get_latest_id() == latest + 1


def _typed_lake(root) -> str:
    """Two files of the types a served batch carries: int64 keys, floats
    with NaN, -0.0 and inf, dictionary strings with nulls, dates with
    nulls, and a nullable int column."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(23)
    for i in range(2):
        n = 400
        f = np.round(rng.standard_normal(n), 3)
        f[:4] = [np.nan, -0.0, np.inf, -np.inf]
        s = [None if j % 17 == 0 else f"s{int(x):02d}" for j, x in enumerate(rng.integers(0, 30, n))]
        d = [None if j % 13 == 0 else datetime.date(1996, 1, 1) + datetime.timedelta(days=int(x))
             for j, x in enumerate(rng.integers(0, 900, n))]
        nn = [None if j % 11 == 0 else int(x) for j, x in enumerate(rng.integers(-50, 50, n))]
        pq.write_table(pa.table({
            "k": np.arange(i * n, (i + 1) * n, dtype=np.int64), "f": f, "s": pa.array(s),
            "d": pa.array(d, type=pa.date32()), "n": pa.array(nn, type=pa.int64()),
        }), os.path.join(root, f"part-{i:05d}.parquet"))
    return str(root)


@pytest.mark.parametrize("sql", [
    "SELECT k, f, s, d, n FROM t WHERE k < 300",
    "SELECT s, count(*) AS c, sum(n) AS sn, min(d) AS md FROM t GROUP BY s",
    "SELECT k, f FROM t WHERE s = 's07' ORDER BY f DESC LIMIT 9",
    "SELECT k FROM t WHERE k < 0",
])
def test_worker_endpoint_wire_bytes_equal_the_jax_package(tmp_path, sql):
    """The process hop: the same query through each package's
    ``QueryServer`` behind its ``WorkerEndpoint`` (native decode on, so
    strings arrive dictionary-backed) gives the same ``/query`` body byte
    for byte, and each package's ``FrontDoor`` turns it back into the same
    numpy columns."""
    import urllib.parse
    import urllib.request

    lake = _typed_lake(tmp_path / "lake")
    bodies, columns = {}, {}
    for pkg, mod in PACKAGES.items():
        kw = {"device": "cpu"} if mod is ht else {}
        sess = mod.Session(conf={mod.keys.SYSTEM_PATH: str(tmp_path / pkg),
                                 "hyperspace.exec.io.native.enabled": True}, **kw)
        sess.register_view("t", sess.read_parquet(lake))
        fabric = _module(pkg, "fabric")
        with _module(pkg, "serving").QueryServer(sess, workers=1, name="qsW") as srv:
            with fabric.WorkerEndpoint(srv) as ep:
                url = f"{ep.url}/query?{urllib.parse.urlencode({'sql': sql, 'tenant': 't'})}"
                with urllib.request.urlopen(url, timeout=60) as resp:
                    bodies[pkg] = resp.read()
                columns[pkg] = fabric.FrontDoor([ep.url]).query(sql, tenant="t", timeout=60)
    assert bodies["hyperspace_tpu_torch"] == bodies["hyperspace_tpu"]
    got, want = columns["hyperspace_tpu_torch"], columns["hyperspace_tpu"]
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
