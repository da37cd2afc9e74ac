"""Quarantine records and the dead-letter queue (DESIGN.md §14.3; the port
of the reference's ``resilience/quarantine.py``, a copy: numpy and stdlib
only).

When a tenant's steps fail ``quarantine_after`` times in a row, the service
freezes it: the drained-but-unapplied batches of the final attempt are
preserved verbatim in a ``DeadLetterQueue`` (the forensic record AND the
replay source for ``heal``), and a ``QuarantineEntry`` carries the
structured reason every subsequent no-op step reports.

This module is import-light on purpose (numpy + stdlib only): the service,
the ladder, and core engine modules can all reach it without cycles.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuarantineEntry:
    """Why a tenant is frozen (returned by ``service.quarantined``)."""

    reason: str          # classified failure reason (rollback counter label)
    error: str           # repr of the final exception
    since_version: int   # last-good committed version (still being served)
    failures: int        # consecutive failed steps that tripped the freeze


@dataclasses.dataclass(frozen=True)
class DeadLetter:
    """One failed drain: the batches that could not be applied.

    ``batches`` is a tuple of ``(inserts, deletes)`` numpy pairs in original
    vertex ids, in submit order — exactly what ``heal(mode='replay')``
    re-applies."""

    tenant: str
    batches: tuple       # ((ins, dels), ...) numpy (k, 2) int64 pairs
    reason: str
    error: str
    version: int         # tenant version the drain failed against
    seq: int             # service-wide step sequence number

    def n_edges(self) -> int:
        return sum(len(i) + len(d) for i, d in self.batches)


class DeadLetterQueue:
    """Bounded FIFO of ``DeadLetter``s (oldest dropped past ``cap``)."""

    def __init__(self, cap: int = 64):
        self._q: "collections.deque[DeadLetter]" = collections.deque(
            maxlen=max(1, int(cap)))

    def __len__(self) -> int:
        return len(self._q)

    def push(self, letter: DeadLetter) -> None:
        self._q.append(letter)

    def letters(self, tenant: Optional[str] = None) -> list[DeadLetter]:
        return [dl for dl in self._q
                if tenant is None or dl.tenant == tenant]

    def drain(self, tenant: str) -> list[DeadLetter]:
        """Remove and return ``tenant``'s letters (oldest first) — used by
        a successful replay heal, which has applied them."""
        mine = self.letters(tenant)
        for dl in mine:
            self._q.remove(dl)
        return mine

    def export_jsonl(self, path) -> int:
        """Write one JSON object per letter (CI chaos artifacts); returns
        the number written."""
        n = 0
        with open(path, "w") as f:
            for dl in self._q:
                f.write(json.dumps({
                    "tenant": dl.tenant, "reason": dl.reason,
                    "error": dl.error, "version": dl.version,
                    "seq": dl.seq, "n_batches": len(dl.batches),
                    "batches": [
                        {"inserts": np.asarray(i).tolist(),
                         "deletes": np.asarray(d).tolist()}
                        for i, d in dl.batches],
                }) + "\n")
                n += 1
        return n
