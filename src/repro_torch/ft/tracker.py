"""Pluggable metrics trackers for the fault-tolerant trainer.

Counterpart of the reference's ``repro/ft/tracker.py``: the same records
and, for the same calls, the same JSONL lines byte for byte.

The Levanter-shaped seam: the trainer emits structured records through a
tiny :class:`Tracker` protocol instead of printing or hoarding them, so
runs can stream metrics to a jsonl file, stdout, an in-memory buffer, or
all three — without the trainer knowing which.

Record kinds emitted by the trainer (the ``kind`` field):

``step``        per training step: step index, loss, virtual step seconds;
``checkpoint``  per completed checkpoint: level (1 buddy / 2 deep), C_s;
``failure``     per injected failure: hard?, downtime, recovery level/secs,
                rollback target step;
``summary``     once at run end: wall/energy/policy/prediction report.

Every record carries ``t`` — the trainer's virtual clock (seconds).
"""
from __future__ import annotations

import json
from typing import Iterable, Optional, Protocol, runtime_checkable


@runtime_checkable
class Tracker(Protocol):
    """Anything with ``log(record: dict) -> None`` and ``close()``."""

    def log(self, record: dict) -> None: ...

    def close(self) -> None: ...


class NullTracker:
    """Discards everything (the trainer default)."""

    def log(self, record: dict) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryTracker:
    """Keeps records in a list — the test/benchmark backend."""

    def __init__(self):
        self.records: list = []

    def log(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass

    def of_kind(self, kind: str) -> list:
        return [r for r in self.records if r.get("kind") == kind]


class StdoutTracker:
    """Human-readable one-liners; ``kinds`` filters what is printed."""

    def __init__(self, kinds: Optional[Iterable[str]] = None):
        self.kinds = None if kinds is None else set(kinds)

    def log(self, record: dict) -> None:
        kind = record.get("kind", "?")
        if self.kinds is not None and kind not in self.kinds:
            return
        body = " ".join(f"{k}={_fmt(v)}" for k, v in record.items()
                        if k != "kind")
        print(f"[{kind}] {body}")

    def close(self) -> None:
        pass


class JsonlTracker:
    """One JSON object per line; the machine-readable run log."""

    def __init__(self, path):
        self.path = path
        self._fh = open(path, "w")

    def log(self, record: dict) -> None:
        self._fh.write(json.dumps(record, default=_jsonable) + "\n")

    def close(self) -> None:
        self._fh.flush()
        self._fh.close()


class CompositeTracker:
    """Fan a record out to several backends."""

    def __init__(self, *trackers: Tracker):
        self.trackers = list(trackers)

    def log(self, record: dict) -> None:
        for t in self.trackers:
            t.log(record)

    def close(self) -> None:
        for t in self.trackers:
            t.close()


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return v


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
