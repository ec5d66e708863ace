"""The port's plain segment-reduce versions against the reference's ops.

``segment_sum`` and ``gather_min64`` (``repro_torch.kernels``) run their
plain torch versions on CPU tensors; the same NumPy-seeded inputs go
through the reference's ops in ``xla`` mode (its jitted ``ref.py``
oracle) at the shapes of ``tests/test_kernels.py``.  Outputs must be equal
exactly: counts as integers, estimates as 64-bit patterns (the reference
returns them as (hi, lo) u32 planes).  ``sketch_add``, ``segment_sum``'s
key form, is held bit for bit against the reference's ``DecaySketch``
(decay, then a host add) and against its ``segment_sum`` on the same
host-hashed ids.  The CUDA kernels run only on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from _hypothesis_support import given, settings, st

from repro import kernels as R
from repro.core.adaptive import DecaySketch as RefSketch
from repro_torch import kernels as T


def _ref_min64(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The reference op on f64 counters -> the u64 patterns of its min."""
    d, w = vals.shape
    v = np.ascontiguousarray(vals).view(np.uint32).reshape(d, w, 2)
    oh, ol = R.gather_min64(v[..., 1], v[..., 0], idx.astype(np.int32),
                            mode="xla")
    return (oh.astype(np.uint64) << np.uint64(32)) | ol.astype(np.uint64)


def _port_min64(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    bits = torch.from_numpy(np.ascontiguousarray(vals).view(np.int64).copy())
    got = T.gather_min64(bits, torch.from_numpy(idx.astype(np.int64)))
    assert got.dtype == torch.int64 and got.shape == (idx.shape[0],)
    return got.numpy().view(np.uint64)


# ------------------------------------------------------------ segment_sum
@pytest.mark.parametrize("m,slots", [(0, 8), (1, 1), (13, 7), (300, 64),
                                     (100, 1000), (8192, 8192),
                                     (1024, 32768), (5, 0), (40, 1)])
def test_segment_sum_matches_reference(m, slots):
    rng = np.random.default_rng(m * 31 + slots)
    ids = rng.integers(-1, slots + 2, m)        # includes out-of-range
    got = T.segment_sum(torch.from_numpy(ids), slots)
    assert got.dtype == torch.int64 and got.shape == (slots,)
    assert_array_equal(got.numpy(), R.segment_sum(ids, slots, mode="xla"))
    valid = ids[(ids >= 0) & (ids < slots)]
    assert_array_equal(got.numpy(), np.bincount(valid, minlength=slots))


@pytest.mark.parametrize("case", ["all_masked", "beyond_slots", "one_slot"])
def test_segment_sum_masks(case):
    ids = {"all_masked": np.full(64, -1), "beyond_slots": np.arange(10, 20),
           "one_slot": np.array([0, 0, -1, 1, 0])}[case].astype(np.int64)
    slots = 1 if case == "one_slot" else 10
    got = T.segment_sum(torch.from_numpy(ids), slots).numpy()
    assert_array_equal(got, R.segment_sum(ids, slots, mode="xla"))
    assert got.sum() == (3 if case == "one_slot" else 0)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(-2, 70), min_size=0, max_size=200),
       st.sampled_from([1, 17, 64]))
def test_segment_sum_property(ids, slots):
    a = np.array(ids, np.int64)
    got = T.segment_sum(torch.from_numpy(a), slots).numpy()
    assert_array_equal(got, R.segment_sum(a, slots, mode="xla"))


# the inputs the index form's one-launch kernel must count exactly: the
# lifetime histogram's add (one id a row of 32 slots, ascending, distinct),
# every id on one slot, and far more ids than slots (out-of-range ones too)
@pytest.mark.parametrize("case", ["tracker_1018", "tracker_33", "one_slot",
                                  "many_ids"])
def test_segment_sum_contract_inputs(case):
    rng = np.random.default_rng(23)
    if case.startswith("tracker"):
        rows = int(case.split("_")[1])
        ids = np.arange(rows) * 32 + rng.integers(0, 32, rows)
        slots = rows * 32
    elif case == "one_slot":
        ids, slots = np.full(5000, 777), 1024
    else:
        ids, slots = rng.integers(-3, 20, 50000), 17
    ids = ids.astype(np.int64)
    got = T.segment_sum(torch.from_numpy(ids), slots).numpy()
    assert_array_equal(got, R.segment_sum(ids, slots, mode="xla"))
    valid = ids[(ids >= 0) & (ids < slots)]
    assert_array_equal(got, np.bincount(valid, minlength=slots))
    if case == "one_slot":
        assert got[777] == 5000 and got.sum() == 5000


# ----------------------------------------------------------- gather_min64
@pytest.mark.parametrize("d,w,q", [(1, 1, 1), (2, 50, 33), (4, 100, 64),
                                   (3, 7, 1), (2, 4096, 4096)])
def test_gather_min64_matches_reference(d, w, q):
    rng = np.random.default_rng(d * 100 + w + q)
    vals = rng.random((d, w)) * 1e6             # non-negative f64
    vals[rng.random((d, w)) < 0.2] = 0.0
    idx = rng.integers(0, w, (q, d))
    got = _port_min64(vals, idx)
    assert_array_equal(got, _ref_min64(vals, idx))
    want = vals[np.arange(d)[None, :], idx].min(axis=1)
    assert_array_equal(got.view(np.float64), want)


def test_gather_min64_orders_low_word_and_signed_zero_as_u64():
    """Patterns equal in the high word are ordered by the low word, and
    -0.0 (sign bit set) orders above every non-negative value, as the
    reference's lexicographic (hi, lo) compare orders them."""
    base = np.array([1.5], np.float64).view(np.uint64)[0]
    row0 = np.array([base + 7, 0, np.array(-0.0).view(np.uint64)], np.uint64)
    row1 = np.array([base + 3, 2**63 - 1, 5], np.uint64)
    vals = np.stack([row0, row1]).view(np.float64)
    idx = np.array([[0, 0], [1, 1], [2, 2], [2, 1]])
    got = _port_min64(vals, idx)
    assert_array_equal(got, _ref_min64(vals, idx))
    assert_array_equal(got, [base + 3, 0, 5, 2**63 - 1])


def test_gather_min64_empty_queries_and_outside_index():
    bits = torch.arange(6, dtype=torch.int64).reshape(2, 3) + 10
    assert T.gather_min64(bits, torch.zeros((0, 2), dtype=torch.int64)) \
        .shape == (0,)
    # an index outside [0, W) fetches the pattern 0 (never out of bounds)
    got = T.gather_min64(bits, torch.tensor([[3, 0], [-1, 2], [1, 1]]))
    assert got.tolist() == [0, 0, 11]


@settings(max_examples=20, deadline=None)
@given(st.lists(st.floats(0.0, 1e12, allow_nan=False), min_size=2,
                max_size=40))
def test_gather_min64_property(vals_flat):
    w = len(vals_flat) // 2
    vals = np.array(vals_flat[:2 * w], np.float64).reshape(2, w)
    idx = np.stack([np.arange(w), np.arange(w)], axis=1)
    got = _port_min64(vals, idx)
    assert_array_equal(got, _ref_min64(vals, idx))
    assert_array_equal(got.view(np.float64), np.minimum(vals[0], vals[1]))


# ------------------------------------------------------------- sketch_add
def _col(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


def _sketch_keys(kind: str, rng, q: int) -> np.ndarray:
    if kind == "equal":                     # every key in one slot a row
        return np.full(q, 0xDEADBEEF, np.uint64)
    keys = rng.integers(0, 2**64 - 1, q, dtype=np.uint64, endpoint=True)
    if kind == "top_bit":                   # u64 patterns >= 2^63
        keys |= np.uint64(1 << 63)
    keys[:2] = [2**63, 2**64 - 1]
    return keys


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("width", [1, 3, 4096, 4097])
def test_sketch_add_matches_reference(width, depth):
    """Decayed, fractional counters: ``sketch_add(scale=f)`` equals the
    reference sketch's ``decay_to`` then ``add`` bit for bit, and the
    reference's ``segment_sum`` on the same host-hashed ids, added once a
    slot after the decay."""
    rng = np.random.default_rng(width * 10 + depth)
    kind = ("uniform", "equal", "top_bit")[(width + depth) % 3]
    keys = _sketch_keys(kind, rng, 700)
    ref = RefSketch(width, depth, half_life=300.0, seed=width + depth)
    start = rng.random((depth, width)) * 100.0
    start[rng.random((depth, width)) < 0.3] = 0.0
    ref.counts[:] = start
    ref.decay_to(117.0)
    ref.add(keys)
    scale = 0.5 ** (117.0 / 300.0)          # the reference's decay factor
    got = torch.from_numpy(start.copy())
    T.sketch_add(got, _col(keys), _col(ref._seeds), scale=scale)
    assert_array_equal(got.numpy().view(np.int64), ref.counts.view(np.int64))
    ids = (ref._rows(keys) + np.arange(depth)[:, None] * width).ravel()
    seg = R.segment_sum(ids, depth * width, mode="xla").reshape(depth, width)
    want = start * scale + seg
    assert_array_equal(got.numpy().view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("case", ["no_keys_scales", "no_keys_no_scale",
                                  "unit_counts"])
def test_sketch_add_edges(case):
    rng = np.random.default_rng(3)
    ref = RefSketch(50, 2, half_life=None, seed=5)
    start = rng.random((2, 50)) * 7.0
    got = torch.from_numpy(start.copy())
    seeds = _col(ref._seeds)
    if case == "unit_counts":               # integer counters stay exact
        keys = _sketch_keys("uniform", rng, 300)
        T.sketch_add(got, _col(keys), seeds)
        ref.counts[:] = start
        ref.add(keys)
        want = ref.counts
    else:
        scale = 0.25 if case == "no_keys_scales" else None
        T.sketch_add(got, _col(np.zeros(0, np.uint64)), seeds, scale=scale)
        want = start * (0.25 if scale else 1.0)
    assert_array_equal(got.numpy().view(np.int64), want.view(np.int64))


def test_sketch_add_rejects_bad_operands():
    counts = torch.zeros((2, 8), dtype=torch.float64)
    keys = torch.zeros(5, dtype=torch.int64)
    seeds = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="float64"):
        T.sketch_add(counts.float(), keys, seeds)
    with pytest.raises(ValueError, match="float64"):
        T.sketch_add(counts.t(), keys, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="seeds"):
        T.sketch_add(counts, keys, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        T.sketch_add(counts, keys.int(), seeds)
    with pytest.raises(ValueError, match="W >= 1"):
        T.sketch_add(torch.zeros((2, 0), dtype=torch.float64), keys, seeds)


# ----------------------------------------------------- operand validation
def test_segment_reduce_wrappers_reject_bad_operands():
    ids = torch.arange(4)
    with pytest.raises(ValueError, match="int64"):
        T.segment_sum(ids.to(torch.int32), 4)
    with pytest.raises(ValueError, match="1-d"):
        T.segment_sum(ids.reshape(2, 2), 4)
    with pytest.raises(ValueError, match="n_slots"):
        T.segment_sum(ids, -1)
    bits = torch.zeros((2, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        T.gather_min64(bits.double(), torch.zeros((3, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="idx"):
        T.gather_min64(bits, torch.zeros((3, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="D >= 1"):
        T.gather_min64(torch.zeros((0, 5), dtype=torch.int64),
                       torch.zeros((3, 0), dtype=torch.int64))
