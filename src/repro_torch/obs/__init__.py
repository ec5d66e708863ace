"""Null observer: the hook surface of ``repro.obs.observer.NullObserver``.

The core calls these hooks at every instrumentation point; here each one is
a constant-time no-op that never reads or writes the simulated device, so
runs stay byte-identical to the reference's observer-off runs.  Recording
observers (spans, metrics, the amplification ledger) are not ported yet.
"""

from __future__ import annotations

import contextlib

_NULL_CTX = contextlib.nullcontext()


class NullObserver:
    """No-op observer.  Every hook returns immediately; the span and cause
    hooks hand back one shared, reusable null context."""

    enabled = False

    def register_store(self, store) -> str:
        return "0"

    def span(self, store, name, lane="fg", **args):
        return _NULL_CTX

    def instant(self, store, name, lane="fg", **args) -> None:
        pass

    def lane_sync(self, store, lane, t0) -> None:
        pass

    def cause(self, store, **fields):
        return _NULL_CTX

    def on_op(self, store, name, value) -> None:
        pass

    def on_count(self, store, name, n=1) -> None:
        pass

    def on_stall(self, store, us, kind) -> None:
        pass

    def on_space(self, store, event, nbytes) -> None:
        pass

    def on_edit(self, store, kind, nbytes) -> None:
        pass

    def tick(self, store) -> None:
        pass


NULL_OBSERVER = NullObserver()

__all__ = ["NULL_OBSERVER", "NullObserver"]
