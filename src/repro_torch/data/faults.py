"""FaultInjectingSource: deterministic I/O chaos for any ``DataSource``.

The port's copy of ``repro.data.faults`` (numpy only), so the port's tests
and ``chip_smoke.py`` inject the same read faults, on the same seeded
schedule, as the reference's.

The resilience layer (core/resilience.py, the fits' retry/rollback
paths) is only trustworthy if it is *exercised* — this wrapper injects
the three fault classes a real streamed fit meets, on a schedule that is
deterministic and replayable:

 - ``io``        — ``read_block`` raises ``IOError`` (transient
   device/NFS fault);
 - ``nan``       — the returned tile has rows overwritten with NaN/Inf
   (a bit-flipped or torn buffer);
 - ``short``     — the returned tile is truncated (partial read);
 - ``hang``      — ``read_block`` sleeps ``hang_s`` seconds before
   returning clean data (a wedged disk / dead NFS mount / stuck worker;
   exercises the distributed coordinator's per-work deadlines);
 - ``slow_read`` — ``read_block`` sleeps ``slow_read_s`` seconds before
   returning clean data (a straggler, not a failure: short enough that
   deadlines must NOT fire and the chain must stay bitwise identical).

Faults key on the **read-call index**, not the row range: each
``read_block`` call increments a counter, and the fault decision for
call *i* is drawn from ``SeedSequence([seed, i])``. Two consequences,
both load-bearing for tests:

 1. the schedule is bit-reproducible for a given ``seed`` across runs
    and processes;
 2. faults are *transient by construction* — a retry of the same row
    range is a new call index, so the re-read sees a fresh (almost
    certainly clean) draw. A retried fit therefore recovers onto the
    EXACT clean chain: the data that reaches the device is unchanged.

``schedule`` pins faults explicitly (``{call_index: kind}``) for
directed tests — e.g. ``{0: "io"}`` faults the very first read, and
``dict.fromkeys(range(100), "io")`` exhausts any retry budget.

``resident()`` returns None on purpose: this source models a faulty
*streaming* path, so wrapping forces the tiled plane (the resident
fast path never re-reads and has nothing to retry). ``column_mean``
delegates to the inner source unfaulted — the prior's data-dependent
part is computed once before the fit and is not part of the streamed
iteration loop under test.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.source import DataSource

# order matters: probabilities are folded cumulatively in this order, so
# appending new kinds keeps existing (p_io, p_nan, p_short) schedules —
# and therefore existing chaos-test chains — bit-identical
_KINDS = ("io", "nan", "short", "hang", "slow_read")


class FaultInjectingSource(DataSource):
    """Wrap ``inner`` with a seeded, deterministic fault schedule.

    Either give per-call probabilities (``p_io`` / ``p_nan`` /
    ``p_short`` / ``p_hang`` / ``p_slow_read``, drawn independently per
    read-call index from the seed) or an explicit ``schedule`` mapping
    call index -> fault kind. ``hang_s`` / ``slow_read_s`` set the two
    latency kinds' sleep durations (the *when* is seeded; the duration is
    a fixed, deterministic parameter so deadline tests are exact).
    ``max_faults`` bounds the total injections (None = unbounded).
    ``injected`` logs every injection for assertions.
    """

    def __init__(self, inner: DataSource, seed: int = 0,
                 p_io: float = 0.0, p_nan: float = 0.0,
                 p_short: float = 0.0, p_hang: float = 0.0,
                 p_slow_read: float = 0.0,
                 hang_s: float = 30.0, slow_read_s: float = 0.02,
                 schedule: Optional[Dict[int, str]] = None,
                 max_faults: Optional[int] = None):
        if schedule:
            bad = [k for k in schedule.values() if k not in _KINDS]
            if bad:
                raise ValueError(
                    f"unknown fault kind(s) {bad}; known: {_KINDS}")
        probs = (p_io, p_nan, p_short, p_hang, p_slow_read)
        if min(probs) < 0 or sum(probs) > 1:
            raise ValueError(
                "fault probabilities must be >= 0 and sum to <= 1, got "
                f"p_io={p_io} p_nan={p_nan} p_short={p_short} "
                f"p_hang={p_hang} p_slow_read={p_slow_read}")
        if hang_s < 0 or slow_read_s < 0:
            raise ValueError("hang_s/slow_read_s must be >= 0, got "
                             f"hang_s={hang_s} slow_read_s={slow_read_s}")
        self._inner = inner
        self.n, self.d = inner.n, inner.d
        self._seed = int(seed)
        self._p = probs
        self._hang_s = float(hang_s)
        self._slow_read_s = float(slow_read_s)
        self._schedule = dict(schedule) if schedule else None
        self._max_faults = max_faults
        self.calls = 0
        self.injected: List[dict] = []

    # -- DataSource protocol ------------------------------------------------
    def resident(self) -> None:
        return None                     # always stream (see module doc)

    def column_mean(self) -> np.ndarray:
        return self._inner.column_mean()

    def read_block(self, start: int, stop: int) -> np.ndarray:
        i = self.calls
        self.calls += 1
        kind = self._fault_for(i)
        if kind is None or (self._max_faults is not None
                            and len(self.injected) >= self._max_faults):
            return self._inner.read_block(start, stop)
        self.injected.append({"call": i, "kind": kind,
                              "rows": [int(start), int(stop)]})
        if kind == "io":
            raise IOError(
                f"injected I/O fault (read call {i}, "
                f"rows [{start}, {stop}))")
        if kind in ("hang", "slow_read"):
            # latency faults return CLEAN data after the sleep: the chain
            # must be unaffected — only wall clock (and, for hang, the
            # coordinator's deadline machinery) sees these
            time.sleep(self._hang_s if kind == "hang"
                       else self._slow_read_s)
            return self._inner.read_block(start, stop)
        rows = np.array(self._inner.read_block(start, stop))
        rng = self._rng(i)
        if kind == "nan":
            n_bad = max(1, rows.shape[0] // 64)
            bad = rng.choice(rows.shape[0], size=n_bad, replace=False)
            rows[bad] = np.where(rng.random(rows.shape[1]) < 0.5,
                                 np.nan, np.inf).astype(rows.dtype)
            return rows
        # short read: drop a nonzero tail
        cut = int(rng.integers(1, max(2, rows.shape[0])))
        return rows[:-cut] if rows.shape[0] else rows

    # -- schedule -----------------------------------------------------------
    def _rng(self, call: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, call]))

    def _fault_for(self, call: int) -> Optional[str]:
        if self._schedule is not None:
            return self._schedule.get(call)
        if not any(self._p):
            return None
        u = float(self._rng(call).random())
        acc = 0.0
        for kind, p in zip(_KINDS, self._p):
            acc += p
            if u < acc:
                return kind
        return None
