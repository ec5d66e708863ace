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


@pytest.mark.parametrize("engine", ["titan", "scavenger"])
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
