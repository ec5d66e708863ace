"""Batched serving engine: continuous batching over fixed decode slots.

The counterpart of the reference package's ``serve/engine.py``.  Each slot
holds a dense per-slot KV cache (``Model.serve_step``); HBM paging policy
(admission, eviction, GC) is delegated to the Scavenger
``PagedKVCacheManager``, which accounts pages for every slot's cache
growth, and every request's page-table record lives in a metadata
``Store`` or ``ShardedStore`` (the port's).  Greedy sampling.  The model,
its cache and the metadata store run on ``device``: CUDA unless the caller
names another, raising without one.

As in the reference, one decode call runs every slot at the position of
the slot it samples, with token 0 in the others, and writes that call's
keys and values at that position in *every* slot's cache rows (ROADMAP
§3, reference properties); the token streams depend on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import EngineConfig, ShardedStore, Store, WriteBatch
from repro_torch.core.accel import resolve_device
from repro_torch.core.adaptive import TEMP_WARM

from .paged_cache import PagedKVCacheManager

# Bytes one page costs in a rid's metadata record (the vsize written at
# admission and decoded by restore_page_tables: vsize // _PAGE_META_BYTES
# = reserved page count).
_PAGE_META_BYTES = 16


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    hot: bool = True        # False for long-lived shared-prefix requests
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, batch_slots: int = 4, cache_len: int = 256,
                 page_size: int = 16, hbm_pages: int | None = None,
                 meta_store: Store | None = None,
                 meta_shards: int = 1, meta_shard_policy: str = "hash",
                 meta_engine: str = "scavenger", *, device=None):
        """``model`` is a ``Model`` holding its params (the reference's
        engine takes them apart), moved to ``device``."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = model.cfg
        self.slots = batch_slots
        self.cache_len = cache_len
        self.page_size = page_size
        n_pages = hbm_pages or (batch_slots * cache_len // page_size * 2)
        per_layer_pages = max(1, cache_len // page_size)
        self.pager = PagedKVCacheManager(
            n_pages, page_size, extent_pages=max(4, per_layer_pages // 2))
        # per-request paged-cache metadata (page-table records) lives in a
        # small KV store; admission/retirement waves go through the batched
        # write path (one WriteBatch per wave).  meta_shards > 1 shards the
        # metadata store (hash over rids: the rid domain is unbounded, so
        # range partitioning has nothing to split on).  ``meta_engine``
        # selects any registered engine strategy for the metadata store.
        if meta_store is not None:
            self.meta = meta_store
        elif meta_shards > 1:
            self.meta = ShardedStore(
                EngineConfig.scaled(meta_engine, (4 << 20) // meta_shards),
                n_shards=meta_shards, shard_policy=meta_shard_policy,
                key_space=1 << 20, device=self.device)
        else:
            self.meta = Store(EngineConfig.scaled(meta_engine, 4 << 20),
                              device=self.device)
        self.cache = self.model.init_cache(batch_slots, cache_len)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int64)
        self.queue: list[Request] = []
        self.steps = 0

    # ----------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def restore_page_tables(self, scan_chunk: int = 1 << 12) -> list[int]:
        """Rebuild the pager's page reservations from the metadata store.

        After recovering the metadata store (``Store.open`` on its
        durability directory, passed in as ``meta_store``), every live rid
        record re-reserves the page count recorded at admission
        (``_PAGE_META_BYTES`` per page-table entry), so HBM accounting and
        the duplicate-rid admission guard pick up exactly where the
        crashed engine left off.  Scans continue past ``scan_chunk`` rids
        until the keyspace is exhausted.  KV-cache *contents* are model
        state and are recomputed on the next prefill: only the page table
        is durable.  Returns the restored rids."""
        restored = []
        start = 0
        while True:
            pairs = self.meta.multi_scan(np.array([start], np.int64),
                                         count=scan_chunk)[0]
            if not pairs:
                break
            rids = np.array([k for k, _ in pairs], np.uint64)
            res = self.meta.multi_get(rids)
            for rid, found, vsize in zip(rids.tolist(),
                                         res["found"].tolist(),
                                         res["vsize"].tolist()):
                if not found or rid in self.pager.page_tables:
                    continue
                n_pages = max(1, int(vsize) // _PAGE_META_BYTES)
                if self.pager.admit(rid, n_pages,
                                    hot=self._rid_hot(rid, True)):
                    restored.append(rid)
            if len(pairs) < scan_chunk:
                break
            start = int(rids[-1]) + 1
        return restored

    def _admit(self) -> None:
        admitted: list[tuple[int, int]] = []     # (rid, n_pages)
        try:
            for i in range(self.slots):
                if self.slot_req[i] is not None or not self.queue:
                    continue
                req = self.queue[0]
                need = (len(req.prompt) + req.max_new
                        + self.page_size - 1) // self.page_size
                # a live metadata record means this rid already owns pages:
                # admitting it again would corrupt its page table; drop the
                # duplicate before raising so the queue can still drain
                if any(req.rid == a[0] for a in admitted) or bool(
                        self.meta.multi_get(
                            np.array([req.rid], np.uint64))["found"][0]):
                    self.queue.pop(0)
                    req.done = True
                    raise ValueError(
                        f"request id {req.rid} already admitted")
                if not self.pager.admit(req.rid, need,
                                        hot=self._admit_hot(req)):
                    break                  # HBM full: wait for GC headroom
                self.queue.pop(0)
                admitted.append((req.rid, need))
                self.slot_req[i] = req
                self.slot_pos[i] = 0
                # prefill token by token (one decode call a token)
                for t in req.prompt[:-1]:
                    self._single(i, t)
                self._single(i, req.prompt[-1], sample=True)
        finally:
            # record the wave even if a later queue entry was rejected:
            # an admitted request without a metadata record would dodge the
            # duplicate-rid guard
            if admitted:
                rids = np.array([a[0] for a in admitted], np.uint64)
                sizes = np.array([a[1] * _PAGE_META_BYTES
                                  for a in admitted], np.int64)
                t0 = self.meta.io.fg_clock_us
                # everything this metadata write triggers downstream
                # (flushes, compactions, GC) is blamed on admission
                with self.meta.obs.cause(self.meta, origin="admission"):
                    self.meta.write(WriteBatch().puts(rids, sizes))
                # simulated foreground latency of the metadata write on the
                # serving critical path, plus the admitted page mix
                obs = self.meta.obs
                obs.on_op(self.meta, "admission_us",
                          self.meta.io.fg_clock_us - t0)
                obs.on_op(self.meta, "admission_pages",
                          sum(a[1] for a in admitted))

    def _admit_hot(self, req: Request) -> bool:
        """Hot/cold extent placement for a request's pages.

        With ``meta_engine="scavenger_adaptive"`` the metadata store's
        workload tracker has seen every admission/retirement write for this
        rid: a rid whose metadata churns classifies hot, long-lived rids
        cool off to cold extents.  Falls back to the caller's ``req.hot``
        hint when the meta store has no tracker (default engines, sharded
        meta)."""
        return self._rid_hot(req.rid, req.hot)

    def _rid_hot(self, rid: int, default: bool) -> bool:
        tempmap = getattr(getattr(self.meta, "strategy", None),
                          "tempmap", None)
        if tempmap is None:
            return default
        rid = np.array([rid], np.uint64)
        if tempmap.tracker.write_rate(rid)[0] < 1.0:
            # no evidence for this rid: its metadata write happens after
            # admission, so a first-time rid has no observations and the
            # caller's hint stands.  The < 1.0 bar (one undecayed
            # observation) also filters decayed sketch-collision noise.
            return default
        return bool(tempmap.classify(rid)[0] >= TEMP_WARM)

    def _single(self, slot: int, token: int, sample: bool = False) -> None:
        b = torch.zeros((self.slots, 1), dtype=torch.int64)
        b[slot, 0] = token
        logits, self.cache = self.model.serve_step(
            self.cache, {"token": b.to(self.device),
                         "pos": int(self.slot_pos[slot])})
        self.slot_pos[slot] += 1
        if sample:
            req = self.slot_req[slot]
            req.out.append(int(torch.argmax(
                logits[slot, 0, :self.cfg.vocab])))

    def step(self) -> None:
        """One decode step across all occupied slots."""
        self._admit()
        occupied = [i for i in range(self.slots)
                    if self.slot_req[i] is not None]
        if not occupied:
            return
        # slots decode at their own positions: one call a slot
        finished: list[int] = []
        for i in occupied:
            req = self.slot_req[i]
            last = req.out[-1] if req.out else req.prompt[-1]
            self._single(i, last, sample=True)
            if len(req.out) >= req.max_new:
                req.done = True
                self.pager.finish(req.rid)
                self.slot_req[i] = None
                finished.append(req.rid)
        if finished:
            self.meta.write(
                WriteBatch().deletes(np.array(finished, np.uint64)))
        self.steps += 1

    def run(self, max_steps: int = 1000) -> None:
        while (self.queue or any(self.slot_req)) and max_steps > 0:
            self.step()
            max_steps -= 1

    def stats(self) -> dict:
        s = self.pager.stats()
        s["steps"] = self.steps
        s["meta_space_amp"] = self.meta.space_amplification()
        return s
