"""The port's durability (``repro_torch.core.durability``) on the CPU.

* The crash matrix of ``tests/test_durability.py`` on the port: all seven
  engines x the five store crash points (the two GC points only for the
  engines that run standalone GC).  Recovery must be byte-identical to an
  uninterrupted port run at the crash watermark: the whole ``stats()``
  dict equal, every key's latest vid equal.
* Torn MANIFEST and WAL tails, the MANIFEST round trip, WAL prefix
  replay, a recovered store staying durable, and durability costing zero
  simulated time, as in the reference's tests.
* A tracker whose sketches keep their counters on the device writes the
  same tracker records, byte for byte, as one whose sketches are host
  NumPy, and restores resident.
* Across packages: a directory the reference wrote opens in the port and
  continues byte-identically to the reference continuing it, and the
  other way round, for ``scavenger_adaptive`` (tracker arrays compared
  bit for bit) and two paper engines.  Both packages write the same
  format (``records.py`` is a byte-for-byte copy).

Absolute file ids come from a process-wide counter in each package, so the
cross-package checks compare what does not depend on them: stats, vids,
tracker arrays, and the GC score cache's values in insertion order.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from _hypothesis_support import HealthCheck, given, settings, st

import repro.core as R
import repro_torch.core as T
import repro_torch.core.adaptive as TA
from repro_torch.core.adaptive.tracker import _READS_SEED, _WRITES_SEED
from repro_torch.core.durability import (CRASH_POINTS, Durability,
                                         ManifestWriter, VersionEdit,
                                         read_manifest, read_wal,
                                         replay_into)
from repro_torch.core.durability.records import scan_records
from repro_torch.core.durability.snapshot import read_snapshot
from repro_torch.core.durability.wal import WalWriter

N_KEYS = 4096
VSIZES = np.array([64, 200, 600, 2000, 9000], np.int64)
CPU = "cpu"
STORE_POINTS = CRASH_POINTS[:5]          # the four fleet points need sharding
_NO_STANDALONE_GC = ("rocksdb", "blobdb")
MATRIX = [(e, p) for e in T.ENGINES for p in STORE_POINTS
          if not (e in _NO_STANDALONE_GC and p.startswith("gc_"))]


def _cfg(pkg, engine: str):
    return pkg.EngineConfig.scaled(engine, 8 << 20, est_keys=N_KEYS)


def _ops(n_groups: int = 8, seed: int = 7) -> list:
    """The reference test's op stream: puts, deletes, reads per group."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_groups):
        keys = rng.integers(0, N_KEYS, 192).astype(np.uint64)
        sizes = VSIZES[rng.integers(0, len(VSIZES), 192)]
        out.append(("puts", keys, sizes))
        out.append(("dels", rng.integers(0, N_KEYS, 16).astype(np.uint64)))
        out.append(("get", rng.integers(0, N_KEYS, 64).astype(np.uint64)))
    return out


def _apply(pkg, store, op) -> None:
    if op[0] == "puts":
        store.write(pkg.WriteBatch().puts(op[1], op[2]))
    elif op[0] == "dels":
        store.write(pkg.WriteBatch().deletes(op[1]))
    else:
        store.multi_get(op[1])


def _state(store) -> tuple:
    res = store.multi_get(np.arange(N_KEYS, dtype=np.uint64))
    return store.stats(), res["found"].tolist(), res["vid"].tolist()


_REF_CACHE: dict[tuple, tuple] = {}


def _uninterrupted(engine: str, n_applied: int) -> tuple:
    """State of an uninterrupted port run of the first ``n_applied`` ops."""
    key = (engine, n_applied)
    if key not in _REF_CACHE:
        store = T.Store(_cfg(T, engine), device=CPU)
        for op in _ops()[:n_applied]:
            _apply(T, store, op)
        _REF_CACHE[key] = _state(store)
    return _REF_CACHE[key]


# ========================================================== crash matrix
@pytest.mark.parametrize("engine,point", MATRIX)
def test_crash_matrix(engine, point, tmp_path):
    store = T.Store(_cfg(T, engine), durability_dir=tmp_path, device=CPU)
    crashed = False
    for i, op in enumerate(_ops()):
        if i == 8:
            store.checkpoint()          # recovery = snapshot + WAL tail
        if i == 12:
            store.arm_crash(point, hits=2)
        try:
            _apply(T, store, op)
        except T.CrashPoint:
            crashed = True
            break
    applied = store.wal_index            # what reached the journal
    recovered = T.Store.open(tmp_path, device=CPU)
    got, want = _state(recovered), _uninterrupted(engine, applied)
    assert got[0] == want[0], {k: (got[0][k], want[0][k])
                               for k in got[0] if got[0][k] != want[0][k]}
    assert got[1:] == want[1:]
    if point == "after_wal":
        assert crashed


def test_crash_without_checkpoint(tmp_path):
    """No checkpoint: recovery replays the whole journal from scratch."""
    store = T.Store(_cfg(T, "scavenger_adaptive"), durability_dir=tmp_path,
                    device=CPU)
    store.arm_crash("gc_post_chain")
    for op in _ops():
        try:
            _apply(T, store, op)
        except T.CrashPoint:
            break
    recovered = T.Store.open(tmp_path, device=CPU)
    assert _state(recovered) == _uninterrupted("scavenger_adaptive",
                                               store.wal_index)


def test_recovered_store_stays_durable(tmp_path):
    """Post-recovery writes land in a fresh WAL segment: a second reopen
    sees them too."""
    store = T.Store(_cfg(T, "scavenger_adaptive"), durability_dir=tmp_path,
                    device=CPU)
    for op in _ops(2):
        _apply(T, store, op)
    r1 = T.Store.open(tmp_path, device=CPU)
    r1.write(T.WriteBatch().puts(np.array([1], np.uint64),
                                 np.array([123], np.int64)))
    want_vid, want_stats = r1.get(1), r1.stats()
    r1.close()
    r2 = T.Store.open(tmp_path, device=CPU)
    assert r2.stats() == want_stats
    assert r2.get(1) == want_vid


@pytest.mark.parametrize("engine", ["scavenger", "scavenger_adaptive"])
def test_durability_costs_zero_simulated_time(engine, tmp_path):
    plain = T.Store(_cfg(T, engine), device=CPU)
    durable = T.Store(_cfg(T, engine), durability_dir=tmp_path, device=CPU)
    for op in _ops(4):
        _apply(T, plain, op)
        _apply(T, durable, op)
    assert durable.stats() == plain.stats()


@pytest.mark.parametrize("engine", T.ENGINES)
def test_checkpoint_roundtrip_standalone_file(engine, tmp_path):
    store = T.Store(_cfg(T, engine), device=CPU)
    for op in _ops(3):
        _apply(T, store, op)
    snap = store.checkpoint(tmp_path / f"{engine}.ckpt")
    restored = T.Store.open(snap, device=CPU)
    assert restored.stats() == store.stats()
    tracker = getattr(store.strategy, "tracker", None)
    if tracker is not None:
        rt = restored.strategy.tracker
        assert rt.ops == tracker.ops
        for a, b in ((rt.writes.counts, tracker.writes.counts),
                     (rt.lifetime.hist, tracker.lifetime.hist)):
            assert (a.view(np.int64) == b.view(np.int64)).all()


def _tracker_records(path) -> tuple:
    """A snapshot's tracker records: the adaptive meta, and the raw bytes
    of every ``ad_*`` array record."""
    meta, arrays = read_snapshot(path)
    raw = {key: payload for _, key, payload in scan_records(path)
           if key.startswith(b"a:ad_")}
    return meta["adaptive"], raw, arrays


def test_resident_tracker_snapshot_bytes_equal_host_tracker(tmp_path):
    """With kernels on, a tracker's sketches keep their counters on the
    store's device (a CPU tensor here); a twin store whose sketches are
    host NumPy, fed the same ops, writes byte-identical tracker records;
    the resident store's snapshot restores resident sketches holding the
    same bits, and both continue alike."""
    cfg = _cfg(T, "scavenger_adaptive")
    assert cfg.use_kernels
    resident = T.Store(cfg, device=CPU)
    twin = T.Store(cfg, device=CPU)
    tr = twin.strategy.tracker
    tr.writes = TA.DecaySketch(tr.writes.width, tr.writes.depth,
                               tr.writes.half_life, seed=_WRITES_SEED)
    tr.reads = TA.DecaySketch(tr.reads.width, tr.reads.depth,
                              tr.reads.half_life, seed=_READS_SEED)
    assert resident.strategy.tracker.writes._dev is not None
    assert tr.writes._dev is None
    ops = _ops(6)
    for op in ops[:12]:
        _apply(T, resident, op)
        _apply(T, twin, op)
    a = resident.checkpoint(tmp_path / "resident.ckpt")
    b = twin.checkpoint(tmp_path / "twin.ckpt")
    ad_a, raw_a, arr_a = _tracker_records(a)
    ad_b, raw_b, _ = _tracker_records(b)
    assert ad_a["ops"] == ad_b["ops"] > 0
    assert {k: ad_a[k] for k in ("writes_clock", "reads_clock")} \
        == {k: ad_b[k] for k in ("writes_clock", "reads_clock")}
    assert raw_a == raw_b and len(raw_a) == 4
    assert arr_a["ad_wcounts"].any() and arr_a["ad_rcounts"].any()
    restored = T.Store.open(a, device=CPU)
    rt = restored.strategy.tracker
    assert rt.writes._dev is not None and rt.reads._dev is not None
    for got, want in ((rt.writes.counts, arr_a["ad_wcounts"]),
                      (rt.reads.counts, arr_a["ad_rcounts"])):
        assert (got.view(np.int64) == want.view(np.int64)).all()
    for op in ops[12:]:
        _apply(T, restored, op)
        _apply(T, twin, op)
    assert restored.stats() == twin.stats()
    for got, want in ((rt.writes.counts, tr.writes.counts),
                      (rt.reads.counts, tr.reads.counts)):
        assert (got.view(np.int64) == want.view(np.int64)).all()


def test_refusing_to_recreate_existing_dir(tmp_path):
    T.Store(_cfg(T, "scavenger"), durability_dir=tmp_path, device=CPU).close()
    with pytest.raises(FileExistsError):
        T.Store(_cfg(T, "scavenger"), durability_dir=tmp_path, device=CPU)
    with pytest.raises(FileExistsError):
        Durability.create(tmp_path, _cfg(T, "scavenger"))


def test_store_subclass_open_returns_subclass(tmp_path):
    class MyStore(T.Store):
        pass

    d1, d2 = tmp_path / "ckpt", tmp_path / "nockpt"
    s1 = MyStore(_cfg(T, "scavenger"), durability_dir=d1, device=CPU)
    _apply(T, s1, _ops(1)[0])
    s1.checkpoint()
    s1.close()
    assert type(MyStore.open(d1, device=CPU)) is MyStore
    s2 = MyStore(_cfg(T, "scavenger"), durability_dir=d2, device=CPU)
    _apply(T, s2, _ops(1)[0])
    s2.close()
    assert type(MyStore.open(d2, device=CPU)) is MyStore


# ================================================== torn-tail tolerance
def test_torn_manifest_and_wal_tails(tmp_path):
    store = T.Store(_cfg(T, "scavenger"), durability_dir=tmp_path,
                    device=CPU)
    ops = _ops(3)
    for op in ops:
        _apply(T, store, op)
    store.close()
    with open(tmp_path / "MANIFEST", "ab") as fh:
        fh.write(b"\x13torn-tail-garbage")
    with open(sorted(tmp_path.glob("wal-*.log"))[-1], "ab") as fh:
        fh.write(b"\xff" * 7)
    recovered = T.Store.open(tmp_path, device=CPU)
    assert _state(recovered) == _uninterrupted("scavenger", len(ops))


# ============================================== MANIFEST and WAL records
_json_scalars = st.one_of(st.integers(-2**53, 2**53), st.booleans(),
                          st.text(max_size=20), st.none())
_edit_strategy = st.builds(
    VersionEdit,
    kind=st.text(min_size=1, max_size=20),
    data=st.dictionaries(st.text(max_size=10),
                         st.one_of(_json_scalars,
                                   st.lists(_json_scalars, max_size=4)),
                         max_size=4))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(edits=st.lists(_edit_strategy, max_size=20))
def test_manifest_roundtrip_property(edits, tmp_path):
    """Edit sequences survive encode -> append -> decode, and the
    reference reads the port's MANIFEST bytes as the same edits."""
    from repro.core.durability import read_manifest as ref_read_manifest
    path = tmp_path / f"MANIFEST-{abs(hash(str(edits))) % 997}"
    w = ManifestWriter(path)
    for e in edits:
        w.append(e)
    w.close()
    assert read_manifest(path) == edits
    assert [(e.kind, e.data) for e in ref_read_manifest(path)] \
        == [(e.kind, e.data) for e in edits]
    path.unlink()


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(groups=st.lists(
    st.lists(st.tuples(st.integers(0, 255), st.integers(0, 4096)),
             min_size=1, max_size=32),
    min_size=1, max_size=6),
    prefix=st.integers(0, 6))
def test_wal_prefix_replay_idempotent(groups, prefix, tmp_path):
    """Replaying a WAL prefix twice equals replaying it once."""
    path = tmp_path / f"wal-{abs(hash(str(groups))) % 997}.log"
    w = WalWriter(path)
    seq = 0
    for i, g in enumerate(groups):
        keys = np.array([k for k, _ in g], np.uint64)
        sizes = np.array([s for _, s in g], np.int64)
        kinds = (sizes == 0).astype(np.uint8)     # vsize 0 -> delete
        w.append_batch(i + 1, seq + 1, kinds, keys,
                       np.where(kinds == 1, 0, sizes))
        seq += len(g)
    w.close()
    records = read_wal(path)[:prefix]
    once = T.Store(_cfg(T, "scavenger_adaptive"), device=CPU)
    replay_into(once, records)
    twice = T.Store(_cfg(T, "scavenger_adaptive"), device=CPU)
    replay_into(twice, records)
    replay_into(twice, records)               # second pass must no-op
    assert twice.stats() == once.stats()
    assert twice.seq == once.seq and twice.wal_index == once.wal_index
    path.unlink()


def test_ingest_batch_journals_and_replays(tmp_path):
    """``ingest_batch`` keeps the given vids, counts no user write, equals
    the reference's, and an ingest record replays to the same store."""
    store = T.Store(_cfg(T, "scavenger"), durability_dir=tmp_path,
                    device=CPU)
    ref = R.Store(_cfg(R, "scavenger"))
    keys = np.arange(100, 164, dtype=np.uint64)
    vids = np.arange(5000, 5064, dtype=np.uint64)
    kinds = np.zeros(64, np.uint8)
    kinds[::8] = 1                                # some deletes
    for s in (store, ref):
        s.ingest_batch(kinds, keys, vids, np.full(64, 700, np.int64))
    assert store.stats() == ref.stats()
    assert store.user_write_bytes == 0
    assert store.next_vid == 5064
    res = store.multi_get(keys)
    assert (res["found"] == (kinds == 0)).all()
    assert (res["vid"][kinds == 0] == vids[kinds == 0]).all()
    assert read_wal(sorted(tmp_path.glob("wal-*.log"))[0])[0][0] == "i"
    recovered = T.Store.open(tmp_path, device=CPU)
    assert recovered.stats() == store.stats()


# =================================================== across the packages
def _continue(pkg, store, ops) -> tuple:
    for op in ops:
        _apply(pkg, store, op)
    store.flush()                       # journaled, unlike drain()
    stats, found, vids = _state(store)
    tracker = getattr(store.strategy, "tracker", None)
    arrays = []
    if tracker is not None:
        arrays = [a.view(np.int64).tolist() for a in (
            tracker.writes.counts, tracker.reads.counts,
            tracker.lifetime.hist, tracker.lifetime.last_write)]
        arrays.append([tracker.ops,
                       list(store.strategy._soon_cache.values())])
    return stats, found, vids, arrays


def _write_dir(pkg, engine, path, ops, crash: str | None, **dev):
    store = pkg.Store(_cfg(pkg, engine), durability_dir=path, **dev)
    for i, op in enumerate(ops):
        if i == 6:
            store.checkpoint()
        if i == 9 and crash is not None:
            store.arm_crash(crash)
        try:
            _apply(pkg, store, op)
        except pkg.CrashPoint:
            return
    store.close()


@pytest.mark.parametrize("crash", [None, "mid_compaction"])
@pytest.mark.parametrize("engine", ["titan", "scavenger",
                                    "scavenger_adaptive"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_opens_in_the_other_package(writer, engine, crash,
                                              tmp_path):
    """A durable directory written (and maybe crashed) by one package
    recovers in the other and continues byte-identically to the writer's
    own recovery continuing it."""
    ops = _ops(10, seed=3)
    first, rest = ops[:15], ops[15:]
    src_pkg, dst_pkg = (R, T) if writer == "reference" else (T, R)
    src_dev = {"device": CPU} if src_pkg is T else {}
    path, copy = tmp_path / "store", tmp_path / "copy"
    _write_dir(src_pkg, engine, path, first, crash, **src_dev)
    # the writer's own recovery runs on a copy of the directory
    shutil.copytree(path, copy)
    own = src_pkg.Store.open(copy, **src_dev)
    other = dst_pkg.Store.open(
        path, **({"device": CPU} if dst_pkg is T else {}))
    assert other.cfg.state_dict() == own.cfg.state_dict()
    assert other.wal_index == own.wal_index
    assert other.stats() == own.stats()
    assert _continue(dst_pkg, other, rest) == _continue(src_pkg, own, rest)
    # the continued store stays durable in the other package's writing
    want = other.stats()
    other.close()
    assert src_pkg.Store.open(path, **src_dev).stats() == want
