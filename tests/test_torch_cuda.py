"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, never at
collection) when no CUDA device is present.  On a machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must be equal exactly.  This file imports nothing of the
JAX package, so it runs where JAX is not installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import EngineConfig, Store, WriteBatch
from repro_torch.core.engine.keys import BloomFilter, hash_family

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _col(a, device):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.uint64)).view(np.int64)).to(device)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("n,q,hi", [(0, 1, 2**20), (1, 1, 2**20),
                                    (1, 50, 8), (5000, 4096, 2**40),
                                    (3000, 999, 2**64 - 1)])
def test_probe_kernels_match_plain(cuda, n, q, hi):
    rng = np.random.default_rng(n + q)
    keys = np.unique(rng.integers(0, hi, n, dtype=np.uint64, endpoint=True))
    qs = rng.integers(0, hi, q, dtype=np.uint64, endpoint=True)
    if len(keys):
        qs[: q // 2] = keys[rng.integers(0, len(keys), q // 2)]
        qs[0], qs[-1] = keys[0], keys[-1]
    bf = BloomFilter(keys, 10)
    bit_idx = (hash_family(qs, bf.k) % np.uint64(bf.nbits)).T
    qt, rt = _col(qs, cuda), _col(keys, cuda)
    bt, wt = _col(bit_idx, cuda), _col(bf.bits, cuda)
    _equal(K.rank_probe(qt, rt), K.rank_probe_ref(qt, rt))
    _equal(K.lookup_probe(qt, rt, bt, wt), K.lookup_probe_ref(qt, rt, bt, wt))
    _equal((K.count_le(qt, rt),), (K.count_le_ref(qt, rt),))
    mins = np.unique(keys)            # one-key intervals [k, k]
    mt = _col(mins, cuda)
    _equal((K.interval_rank(qt, mt, mt),), (K.interval_rank_ref(qt, mt, mt),))
    rank = K.rank_probe(qt, rt)[1].cpu().numpy()
    assert (rank == np.searchsorted(keys, qs)).all()


@pytest.mark.parametrize("window", [None, 1, 3])
@pytest.mark.parametrize("m", [1, 2, 100, 4096, "cap", "cap+1", 20000])
def test_run_coalesce_matches_plain(cuda, m, window):
    from repro_torch.kernels.common import smem_sort_cap
    if isinstance(m, str):            # either side of the shared-memory sort
        m = smem_sort_cap() + (m == "cap+1")
    rng = np.random.default_rng(m)
    r = _col(rng.integers(0, max(2, m // 10), m), cuda)
    p = _col(rng.integers(0, max(2, m // 2), m), cuda)
    _equal(K.run_coalesce(r, p, window=window),
           K.run_coalesce_ref(r, p, window))


@pytest.mark.parametrize("m,slots", [(0, 8), (1, 1), (13, 7), (300, 64),
                                     (8192, 8192), (1024, 32768), (5, 0)])
def test_segment_sum_matches_plain(cuda, m, slots):
    rng = np.random.default_rng(m + slots)
    ids = torch.from_numpy(rng.integers(-1, slots + 2, m)).to(cuda)
    _equal((K.segment_sum(ids, slots),), (K.segment_sum_ref(ids, slots),))


@pytest.mark.parametrize("d,w,q", [(1, 1, 1), (2, 50, 33), (4, 100, 64),
                                   (3, 7, 1), (2, 4096, 4096)])
def test_gather_min64_matches_plain(cuda, d, w, q):
    rng = np.random.default_rng(d * 100 + w + q)
    vals = rng.random((d, w)) * 1e6
    vals[rng.random((d, w)) < 0.2] = 0.0
    vals[0, 0] = -0.0                     # sign bit set: above every value
    bits = torch.from_numpy(vals.view(np.int64).copy()).to(cuda)
    idx = torch.from_numpy(rng.integers(0, w, (q, d))).to(cuda)
    got = K.gather_min64(bits, idx)
    _equal((got,), (K.gather_min64_ref(bits, idx),))


def test_durable_adaptive_store_opens_on_card(cuda, tmp_path):
    """A durable scavenger_adaptive store on the card recovers on the card
    (``Store.open(..., device="cuda")``) to the CPU store's state."""
    def run(device, path):
        cfg = EngineConfig.scaled("scavenger_adaptive", 8 << 20,
                                  est_keys=4096, kernel_min_batch=1)
        store = Store(cfg, durability_dir=path, device=device)
        rng = np.random.default_rng(2)
        for i in range(6):
            if i == 3:
                store.checkpoint()
            keys = rng.integers(0, 4096, 512).astype(np.uint64)
            store.write(WriteBatch().puts(keys, np.full(512, 1024)))
            store.multi_get(keys[::3])
        store.close()
        rec = Store.open(path, device=device)
        assert rec.device.type == torch.device(device).type
        return rec.stats(), rec.multi_get(
            np.arange(4096, dtype=np.uint64))["vid"].tolist()
    assert run(cuda, tmp_path / "card") == run("cpu", tmp_path / "cpu")


@pytest.mark.parametrize("engine", ["titan", "scavenger",
                                    "scavenger_adaptive"])
def test_store_on_card_matches_cpu(cuda, engine):
    def run(device, **kw):
        cfg = EngineConfig.scaled(engine, 8 << 20, est_keys=4096, **kw)
        store = Store(cfg, device=device)
        rng = np.random.default_rng(1)
        vids = []
        for _ in range(4):
            keys = rng.integers(0, 4096, 512).astype(np.uint64) << 35
            store.write(WriteBatch().puts(keys, np.full(512, 1024)))
            vids.append(store.multi_get(keys[::2])["vid"].tolist())
        store.drain()
        return store.stats(), vids
    assert run(cuda, kernel_min_batch=1) == run("cpu", use_kernels=False)
