"""Tile-read retry for streamed fits, the health check of a model, and
the error of a fit that diverged.

Port of ``repro.core.resilience``'s ``TileReadError``, ``RetryPolicy``,
``read_block_checked`` (the tiled fit reads every tile through it, with the
reference's event records ``tile_read_fault`` and ``io_retry``),
``model_health`` (the fits' guardrails read its verdict with each chunk's
or iteration's history and roll back to the last healthy state on a bad
one, ``core/sampler.py``) and ``DivergenceError`` (raised once
``max_recoveries`` rollbacks are spent). ``WorkerLostError`` waits for the
multi-process fits (ROADMAP.md §1 item 6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.state import ModelState


class TileReadError(RuntimeError):
    """A streamed tile read failed past the retry budget. The message
    carries full provenance: global row range, attempts, last failure."""


class DivergenceError(RuntimeError):
    """The chain diverged (non-finite state / degenerate clusters) and
    rollback could not recover it within ``max_recoveries`` attempts.
    ``recoveries`` holds the per-event log (same records as
    ``FitResult.recoveries``)."""

    def __init__(self, message: str, recoveries: Optional[List[dict]] = None):
        super().__init__(message)
        self.recoveries: List[dict] = list(recoveries or [])


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for streamed tile reads.

    ``max_retries`` is the number of *re*-attempts after the first try
    (so ``max_retries=3`` means at most 4 reads of the block). Backoff
    sleeps ``backoff_s * backoff_mult**i`` before retry i — transient
    faults (NFS hiccup, loaded disk) get breathing room, while the bound
    keeps a dead source from hanging the fit. ``guard_nonfinite`` treats
    NaN/Inf rows in a tile as a retryable fault too: a re-read of a
    bit-flipped buffer is clean, and a *persistently* non-finite tile
    (really-broken data) fails loudly instead of poisoning the chain.
    """
    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    guard_nonfinite: bool = True


def read_block_checked(source, start: int, stop: int,
                       policy: RetryPolicy,
                       on_event: Optional[Callable[[dict], None]] = None
                       ) -> np.ndarray:
    """``source.read_block(start, stop)`` under ``policy``.

    Validates every read: row count must match (short reads retry) and,
    with ``policy.guard_nonfinite``, all values must be finite. Each
    failed attempt is reported to ``on_event`` (the fits append these
    records to ``FitResult.recoveries``); exhaustion raises
    :class:`TileReadError` with the tile's provenance.
    """
    want = stop - start
    last = "no attempt made"
    for attempt in range(policy.max_retries + 1):
        if attempt:
            delay = policy.backoff_s * policy.backoff_mult ** (attempt - 1)
            if delay > 0:
                time.sleep(delay)
        try:
            rows = source.read_block(start, stop)
        except (IOError, OSError) as e:
            last = f"{type(e).__name__}: {e}"
        else:
            if rows.shape[0] != want:
                last = (f"short read: got {rows.shape[0]} rows, "
                        f"want {want}")
            elif (policy.guard_nonfinite
                  and not np.isfinite(rows).all()):
                bad = np.flatnonzero(~np.isfinite(rows).all(axis=1))
                last = (f"non-finite values in {bad.size} row(s), first "
                        f"at global row {start + int(bad[0])}")
            else:
                if attempt and on_event is not None:
                    # recovered after retries: leave an audit trail, not
                    # just the per-attempt fault records (a fit that only
                    # succeeded on re-reads should say so in recoveries)
                    on_event({"kind": "io_retry",
                              "rows": [int(start), int(stop)],
                              "attempts": attempt + 1,
                              "detail": f"recovered after {attempt} "
                                        f"retr{'y' if attempt == 1 else 'ies'}"
                                        f"; last failure: {last}"})
                return rows
        if on_event is not None:
            on_event({"kind": "tile_read_fault",
                      "rows": [int(start), int(stop)],
                      "attempt": attempt + 1, "detail": last})
    raise TileReadError(
        f"read_block rows [{start}, {stop}) failed after "
        f"{policy.max_retries + 1} attempt(s); last failure: {last}")


def model_health(model: ModelState) -> torch.Tensor:
    """0-d bool tensor: is ``model`` numerically sane? All O(K) checks on
    the active slots only (inactive slots never receive points): every
    sufficient-statistic leaf of ``stats`` and ``substats`` is finite,
    ``logweights`` are finite, and every count ``n`` is non-negative. A
    multi-chain state gets one verdict for all its chains. It only reads,
    and stays on the device."""
    active = model.active
    ok = torch.ones((), dtype=torch.bool, device=active.device)
    for tree in (model.stats, model.substats):
        for f in dataclasses.fields(tree):
            leaf = getattr(tree, f.name)
            if not leaf.is_floating_point():
                continue
            mask = active.reshape(active.shape
                                  + (1,) * (leaf.ndim - active.ndim))
            ok = ok & torch.isfinite(torch.where(mask, leaf, 0.0)).all()
    ok = ok & torch.isfinite(torch.where(active, model.logweights, 0.0)).all()
    return ok & (torch.where(active, model.stats.n, 0.0) >= 0.0).all()
