"""Coordinator of the elastic multi-process fit (repro_torch.dist).

Port of ``repro.dist.coordinator``: the third fit driver
(``DPMMConfig.workers=N``, dispatched from ``DPMM.fit``). It is the tiled
plane's loop (``DPMM._fit_tiled``) with its passes on worker processes
(``WorkerPasses``): one coordinator process owns the ``ModelState`` and
every O(K) step — steps (a)-(d), the split/merge plan, the stat folds, the
guardrails and auto-checkpointing — on its device, while N spawned worker
processes (``repro_torch.dist.worker``), on the same card or on the CPU,
run the tiled plane's tile bodies (``sampler.tile_body``) over contiguous,
STATS_BLOCK-aligned row ranges of x (``core/distributed.shard_ranges``),
each cut into work items of at most a tile and at most one stat window
of the dense slab (``labelstats.window_rows``: no item ships more than
``labelstats.WINDOW_BYTES`` of partials).

**The bitwise fold.** The single-process tiled fit folds the kernels'
per-STATS_BLOCK stat partials into its accumulator left to right in global
point order (``labelstats.fold_stats``, ``csrc/fold_partials.cu`` on the
card). Workers ship their partials per block, unfolded, and the
coordinator folds each work item's as soon as every item before it has
been folded, through the same ``fold_stats`` from the same zero
accumulator: the same adds in the same order. So at any worker count the
chain is the port's single-process tiled fit bit for bit, on the card and
on the CPU (labels, every history row, the final state), and failover
changes nothing but the wall clock: any worker recomputes any block to the
same bits (per-point draws are counter-based on the global index, and the
model reaches the workers losslessly through ``checkpoint.dumps_model``,
the split/merge and compaction plans through ``proto.pack_tree`` with
their integer dtypes).

**The compact slab** follows the port's tiled plane (``sampler._slab``:
headroom 2 from the live count the iteration starts from), not the
reference coordinator's headroom 1 for the sweep and 2 for the move: the
slab is part of the chain (the Threefry top bin, ROADMAP.md §3), and the
distributed chain must equal the port's tiled chain.

**The failure model**, as the reference's. Workers heartbeat every
``worker_heartbeat_s``; each work item has a ``worker_deadline_s``
deadline. A dead worker (SIGKILL, crash) surfaces as EOF on its reader
thread; a hung one keeps beating but misses its deadline and is killed.
Either way its item is requeued to the survivors, a ``worker_failover``
event lands in ``FitResult.recoveries``, and the slot is respawned with
``RetryPolicy`` backoff at most ``max_worker_retries`` times.
:class:`WorkerLostError` is raised only when work is pending, no worker is
alive and every respawn budget is spent.

**Processes.** Workers are started with ``subprocess`` as ``python -m
repro_torch.dist.worker`` (never by forking a process that has touched
CUDA), with ``PYTHONPATH`` naming this checkout's ``src``. On the card the
coordinator builds the kernels before it spawns (``build.build``, under
the build lock) and the workers only load them. ``READY_TIMEOUT_S`` bounds
spawn -> HELLO -> INIT -> warmup -> READY.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dist import proto

# Bound on spawn -> HELLO -> INIT -> warmup -> READY; work deadlines stay
# tight because warmup runs every phase before READY.
READY_TIMEOUT_S = 600.0
# Silence allowed from a worker between INIT and READY: its import of torch
# holds the interpreter lock (and so its heartbeat thread) for seconds on a
# loaded host; a worker that dies meanwhile is seen at once (EOF).
STARTUP_SILENCE_S = 60.0


class _HandshakeError(RuntimeError):
    """A worker failed to come up (died before HELLO, a wrong id, an error
    instead of READY)."""


@dataclasses.dataclass
class DistHooks:
    """Fault and observation hooks for tests and smoke runs.

    ``worker_faults`` maps a worker slot to ``FaultInjectingSource`` kwargs
    applied to that worker's view of x (respawns inherit them: a faulty
    shard stays faulty). ``on_iteration`` runs on the coordinator at the
    top of every iteration with ``(absolute_iter, coordinator)``, e.g. to
    SIGKILL a worker mid-fit."""
    worker_faults: Optional[Dict[int, dict]] = None
    on_iteration: Optional[Callable[[int, "Coordinator"], None]] = None


class _Worker:
    """The coordinator's view of one worker slot."""

    def __init__(self, slot: int):
        self.slot = slot
        self.proc: Optional[subprocess.Popen] = None
        self.conn: Optional[socket.socket] = None
        self.alive = False
        self.item: Optional[Tuple[int, int, int]] = None
        self.deadline: Optional[float] = None
        self.last_seen = 0.0
        self.respawns = 0
        # incarnation: bumped on every (re)connect; a message read under
        # an older one (a dead process's buffered result or EOF) is stale
        self.epoch = 0

    @property
    def id(self) -> str:
        return f"w{self.slot}"


class Coordinator:
    """Worker-pool plumbing: spawn and handshake, scatter and gather with
    deadlines, failover, bounded respawn. The passes live in
    :class:`WorkerPasses`."""

    def __init__(self, cfg, init_meta: dict, events: List[dict],
                 hooks: Optional[DistHooks] = None):
        self.cfg = cfg
        self.events = events
        self.hooks = hooks or DistHooks()
        self._init_meta = init_meta
        self._inbox: "queue.Queue" = queue.Queue()
        self._cur_phase: Optional[Tuple[dict, dict]] = None
        self.respawns_done = 0
        self.reassignments = 0
        # several heartbeats must go missing before an idle worker is
        # declared dead
        self._liveness_s = max(10 * cfg.worker_heartbeat_s, 5.0)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(max(cfg.workers * 2, 8))
        self._port = self._listener.getsockname()[1]
        self.workers = [_Worker(s) for s in range(cfg.workers)]
        t0 = time.perf_counter()
        deadline = time.monotonic() + READY_TIMEOUT_S
        try:
            for w in self.workers:
                self._spawn(w)
            # accept in arrival order (workers start in parallel), then
            # confirm READY slot by slot
            todo = {w.id: w for w in self.workers}
            while todo:
                conn, wid = self._accept_hello(deadline)
                w = todo.pop(wid, None)
                if w is None:
                    conn.close()
                    continue
                w.conn = conn
                proto.send_msg(conn, "init", self._slot_init_meta(w.slot))
            for w in self.workers:
                self._wait_ready(w, deadline)
                self._online(w)
        except BaseException:
            self.shutdown()
            raise
        self.ready_s = time.perf_counter() - t0

    # -- spawn / handshake --------------------------------------------------
    def worker_pids(self) -> List[Optional[int]]:
        return [w.proc.pid if w.proc is not None else None
                for w in self.workers]

    def _slot_init_meta(self, slot: int) -> dict:
        meta = dict(self._init_meta)
        faults = (self.hooks.worker_faults or {}).get(slot)
        if faults:
            meta["faults"] = faults
        return meta

    def _spawn(self, w: _Worker) -> None:
        import repro_torch
        env = os.environ.copy()
        src = os.path.dirname(os.path.dirname(os.path.abspath(
            repro_torch.__file__)))
        env["PYTHONPATH"] = (src + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        if self._init_meta.get("device") == "cpu":
            # CPU workers share the cores with the coordinator and each
            # other: OpenMP threads that spin between regions would starve
            # them (a sleeping wait changes no result)
            env.setdefault("OMP_WAIT_POLICY", "PASSIVE")
        w.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist.worker",
             "--connect", f"127.0.0.1:{self._port}", "--id", w.id,
             "--device", str(self._init_meta.get("device", "cuda"))],
            env=env)

    def _accept_hello(self, deadline: float) -> Tuple[socket.socket, str]:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _HandshakeError("timed out waiting for a worker "
                                      "to connect")
            self._listener.settimeout(min(remaining, 5.0))
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                dead = [w.id for w in self.workers
                        if w.conn is None and w.proc is not None
                        and w.proc.poll() is not None]
                if dead:
                    raise _HandshakeError(
                        f"worker(s) {dead} exited before connecting "
                        "(startup crash)")
                continue
            conn.settimeout(self._liveness_s)
            proto.no_delay(conn)
            try:
                kind, meta, _ = proto.recv_msg(conn)
            except (proto.ProtocolError, OSError):
                conn.close()
                continue
            if kind != "hello" or "id" not in meta:
                conn.close()
                continue
            return conn, str(meta["id"])

    def _wait_ready(self, w: _Worker, deadline: float) -> None:
        """Drain heartbeats until READY (the worker warms up meanwhile)."""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _HandshakeError(f"worker {w.id} never became ready")
            w.conn.settimeout(min(remaining, max(self._liveness_s,
                                                 STARTUP_SILENCE_S)))
            try:
                kind, meta, _ = proto.recv_msg(w.conn)
            except (proto.ProtocolError, OSError) as e:
                raise _HandshakeError(
                    f"worker {w.id} lost during startup "
                    f"({type(e).__name__}: {e})")
            if kind == "ready":
                return
            if kind == "error":
                raise _HandshakeError(
                    f"worker {w.id} failed during startup: "
                    f"{meta.get('detail', '')}")
            # heartbeats (and anything else) just keep the clock alive

    def _online(self, w: _Worker) -> None:
        w.conn.settimeout(self._liveness_s)
        w.last_seen = time.monotonic()
        w.alive = True
        w.epoch += 1
        threading.Thread(target=self._reader, args=(w, w.conn, w.epoch),
                         daemon=True).start()

    def _reader(self, w: _Worker, conn: socket.socket, epoch: int) -> None:
        try:
            while True:
                kind, meta, arrays = proto.recv_msg(conn)
                if epoch == w.epoch:
                    w.last_seen = time.monotonic()
                if kind == "heartbeat":
                    continue
                self._inbox.put((w, epoch, kind, meta, arrays))
        except (proto.ProtocolError, OSError) as e:
            self._inbox.put((w, epoch, "__down__",
                             {"detail": f"{type(e).__name__}: {e}"}, {}))

    def _send(self, w: _Worker, kind: str, meta: Optional[dict] = None,
              arrays: Optional[dict] = None) -> bool:
        try:
            proto.send_msg(w.conn, kind, meta, arrays)
            return True
        except (OSError, proto.ProtocolError):
            return False

    # -- failover -----------------------------------------------------------
    def _lost(self, w: _Worker, detail: str,
              pending: Optional[List] = None) -> None:
        """Declare ``w`` lost: kill its process, requeue its work item, log
        the ``worker_failover`` event and respawn it within budget
        (``RetryPolicy`` backoff). Idempotent per incarnation."""
        if not w.alive:
            return
        from repro_torch.core.resilience import RetryPolicy
        w.alive = False
        item, w.item, w.deadline = w.item, None, None
        if w.proc is not None and w.proc.poll() is None:
            w.proc.kill()               # hung or half-dead: no niceties
            w.proc.wait()
        try:
            w.conn.close()
        except OSError:
            pass
        if item is not None and pending is not None:
            pending.append(item)
            self.reassignments += 1
        phase_meta = self._cur_phase[0] if self._cur_phase else {}
        will_respawn = w.respawns < self.cfg.max_worker_retries
        self.events.append({
            "kind": "worker_failover", "worker": w.slot,
            "iter": phase_meta.get("iter"),
            "phase": phase_meta.get("phase"),
            "rows": [int(item[0]), int(item[1])] if item else None,
            "respawn": will_respawn, "detail": detail})
        policy = RetryPolicy(max_retries=self.cfg.max_worker_retries,
                             backoff_s=self.cfg.io_backoff_s)
        t_stall = time.monotonic()
        while w.respawns < policy.max_retries:
            w.respawns += 1
            delay = policy.backoff_s * policy.backoff_mult ** (
                w.respawns - 1)
            if delay > 0:
                time.sleep(delay)
            try:
                self._respawn(w)
                self.respawns_done += 1
                break
            except _HandshakeError as e:
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
                    w.proc.wait()
                self.events.append({
                    "kind": "worker_failover", "worker": w.slot,
                    "iter": phase_meta.get("iter"),
                    "phase": phase_meta.get("phase"), "rows": None,
                    "respawn": w.respawns < policy.max_retries,
                    "detail": f"respawn attempt {w.respawns} failed: {e}"})
        # the respawn handshake blocked the gather loop: credit the stall
        # to every other in-flight deadline, so a peer's death does not
        # shrink the survivors' compute budget
        stall = time.monotonic() - t_stall
        for o in self.workers:
            if o.alive and o.deadline is not None:
                o.deadline += stall

    def _respawn(self, w: _Worker) -> None:
        self._spawn(w)
        deadline = time.monotonic() + READY_TIMEOUT_S
        conn, wid = self._accept_hello(deadline)
        if wid != w.id:
            conn.close()
            raise _HandshakeError(
                f"respawned worker announced id {wid!r}, want {w.id!r}")
        w.conn = conn
        proto.send_msg(conn, "init", self._slot_init_meta(w.slot))
        self._wait_ready(w, deadline)
        if self._cur_phase is not None:
            proto.send_msg(conn, "phase", *self._cur_phase)
        self._online(w)

    # -- phase scatter / gather -----------------------------------------------
    def set_phase(self, meta: dict, arrays: dict) -> None:
        self._cur_phase = (meta, arrays)
        for w in self.workers:
            if w.alive and not self._send(w, "phase", meta, arrays):
                self._lost(w, "phase broadcast failed (connection lost)")

    def run_phase(self, meta: dict, arrays: dict,
                  items: List[Tuple[int, int, int]],
                  item_arrays: Optional[Callable[[int, int], dict]],
                  on_result: Callable[[int, int, dict, dict], None]) -> None:
        """Broadcast the phase, scatter one WORK per item (``(lo, hi,
        preferred_slot)``, sorted by ``lo``), gather the RESULTs with
        deadline and failover handling, and hand each to ``on_result(lo,
        hi, meta, arrays)`` in item order, as soon as every item before it
        has been handed over. Raises :class:`WorkerLostError` when work
        remains and no worker can take it."""
        from repro_torch.core.resilience import WorkerLostError
        self.set_phase(meta, arrays)
        pending = list(items)
        done: Dict[int, Tuple[dict, dict]] = {}
        nxt = 0
        while nxt < len(items):
            self._assign(pending, item_arrays)
            if not any(w.alive for w in self.workers):
                raise WorkerLostError(
                    f"distributed {meta.get('phase')} pass stalled: "
                    f"{len(items) - nxt} row range(s) "
                    "unprocessed, no live workers, and every "
                    f"max_worker_retries={self.cfg.max_worker_retries} "
                    "respawn budget is spent. See .recoveries for the "
                    "failover log.", self.events)
            try:
                w, epoch, kind, m, arrs = self._inbox.get(timeout=0.05)
            except queue.Empty:
                pass
            else:
                if not w.alive or epoch != w.epoch:
                    pass            # stale message from a dead incarnation
                elif kind == "result":
                    if w.item is not None and int(m["lo"]) == w.item[0]:
                        done[int(m["lo"])] = (m, arrs)
                        w.item, w.deadline = None, None
                elif kind == "error":
                    self._lost(w, f"worker error: {m.get('detail', '')}",
                               pending)
                elif kind == "__down__":
                    self._lost(w, m.get("detail", "connection lost"),
                               pending)
            while nxt < len(items) and items[nxt][0] in done:
                lo, hi, _ = items[nxt]
                on_result(lo, hi, *done.pop(lo))
                nxt += 1
            now = time.monotonic()
            for w in self.workers:
                if not w.alive:
                    continue
                if w.item is not None and now > w.deadline:
                    self._lost(w, f"work deadline "
                                  f"({self.cfg.worker_deadline_s}s) missed "
                                  f"for rows [{w.item[0]}, {w.item[1]}) — "
                                  "worker hung", pending)
                elif (w.item is None
                      and now - w.last_seen > self._liveness_s):
                    self._lost(w, "heartbeat lost while idle", pending)

    def _assign(self, pending: List,
                item_arrays: Optional[Callable[[int, int], dict]]) -> None:
        for w in self.workers:
            if not pending:
                return
            if not w.alive or w.item is not None:
                continue
            # the worker's own items first, in row order, then any other
            idx = next((i for i, it in enumerate(pending)
                        if it[2] == w.slot), 0)
            item = pending.pop(idx)
            lo, hi, _pref = item
            arrs = item_arrays(lo, hi) if item_arrays else {}
            if self._send(w, "work", {"lo": int(lo), "hi": int(hi)}, arrs):
                w.item = item
                w.deadline = time.monotonic() + self.cfg.worker_deadline_s
            else:
                pending.insert(0, item)
                self._lost(w, "work send failed (connection lost)",
                           pending)

    # -- teardown -----------------------------------------------------------
    def shutdown(self) -> None:
        """Ask every worker to exit, wait a little, kill what is left."""
        for w in self.workers:
            if w.conn is not None and w.alive:
                try:
                    proto.send_msg(w.conn, "shutdown")
                except (OSError, proto.ProtocolError):
                    pass
        for w in self.workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()
            if w.conn is not None:
                try:
                    w.conn.close()
                except OSError:
                    pass
            w.alive = False
        self._listener.close()


# ---------------------------------------------------------------------------
# The distributed fit (called from DPMM.fit when cfg.workers is set)
# ---------------------------------------------------------------------------
def _materialize(source) -> Tuple[str, Optional[str]]:
    """The .npy file the workers memory-map: the source's own file when it
    has one, else a temporary dump (returned as the path to remove). A
    fault-injecting wrapper is unwrapped: workers' faults come from
    ``DistHooks``."""
    from repro_torch.data.faults import FaultInjectingSource
    src = source
    while isinstance(src, FaultInjectingSource):
        src = src._inner
    fname = getattr(getattr(src, "_x", None), "filename", None)
    if fname and str(fname).endswith(".npy"):
        return str(fname), None
    x = src.resident()
    if x is None:
        x = np.concatenate([src.read_block(s, min(s + 65_536, src.n))
                            for s in range(0, src.n, 65_536)], axis=0)
    fd, path = tempfile.mkstemp(suffix=".npy", prefix="dpmm-dist-")
    os.close(fd)
    np.save(path, np.ascontiguousarray(np.asarray(x, np.float32)))
    return path, path


class WorkerPasses:
    """The tiled plane's passes (``sampler.StreamPasses``'s interface) on
    the workers: each pass broadcasts its phase (the model, the
    split/merge plan or the initial means, and the compaction plan),
    scatters the work items and folds the workers' per-block partials into
    the accumulator item by item in global order. One chain."""

    def __init__(self, dpmm, source, events: List[dict], init_states,
                 hooks: Optional[DistHooks]):
        import torch

        from repro_torch.core.distributed import shard_ranges, tile_plan
        from repro_torch.core.labelstats import window_rows
        from repro_torch.core.sampler import _slab
        from repro_torch.kernels import build

        cfg, family, dev = dpmm.cfg, dpmm.family, dpmm.device
        n, d, k_max = source.n, source.d, cfg.k_max
        self.family, self.dev, self.events, self.n = family, dev, events, n
        self.lead, self.k_max = dev, k_max       # what _init_models reads
        self.tile = tile_plan(n, 1, cfg.tile_size)[1][0][1]
        # work items: the tiles, cut further to the stat windows of the
        # dense slab (the widest accumulator of any pass), so that no
        # item's partials pass labelstats.WINDOW_BYTES, nor its RESULT
        # frame proto.MAX_FRAME_BYTES; every item STATS_BLOCK-aligned
        self.item_rows = window_rows(self.tile, k_max,
                                     family.slot_floats(d))[0][1]
        self.ranges = shard_ranges(n, cfg.workers)
        self.items = [(lo, min(lo + self.item_rows, hi), slot)
                      for r_lo, hi, slot in self.ranges
                      for lo in range(r_lo, hi, self.item_rows)]
        if dev.type == "cuda":
            build.build()              # the workers only load
        k0 = (int(init_states[0].k_hat) if init_states is not None
              else cfg.init_clusters)
        k_c0 = _slab(k0, cfg, k_max)
        warm = {"sweep_k": [] if k_c0 is None else [k_c0],
                "sm_k": [] if k_c0 is None else [min(k_max, 2 * k_c0)]}
        self.data_path, self.tmp_path = _materialize(source)
        init_meta = {"cfg": dataclasses.asdict(cfg),
                     "data_path": self.data_path,
                     "heartbeat_s": cfg.worker_heartbeat_s,
                     "device": str(dev), "item_rows": self.item_rows,
                     "threads": torch.get_num_threads(), "warm": warm}
        self.labels_h = np.zeros(n, np.int32)
        self.sublabels_h = np.zeros(n, np.int32)
        self.pass_bytes: Dict[str, int] = {}
        self.worker_peak: Dict[str, int] = {}
        self.worker_launches: Dict[str, int] = {}
        self._iter = 0
        try:
            self.coord = Coordinator(cfg, init_meta, events, hooks)
        except BaseException:
            self._unlink()
            raise

    def _unlink(self) -> None:
        if self.tmp_path is not None:
            try:
                os.unlink(self.tmp_path)
            except OSError:
                pass

    def _phase_arrays(self, phase: str, args: tuple) -> dict:
        """The phase's broadcast: the model (``checkpoint.dumps_model``),
        the plan (``proto.pack_tree``) or the initial means and
        hyperplanes, with the compaction plan's two index arrays."""
        from repro_torch.core import checkpoint
        if phase == "init2":
            return {"means0": args[0].cpu().numpy(),
                    "v0": args[1].cpu().numpy()}
        if phase == "init1":
            return {}
        comp = args[-1]
        out = ({} if comp is None else
               {"comp0": comp.slot_of_compact.cpu().numpy(),
                "comp1": comp.compact_of_slot.cpu().numpy()})
        if phase == "sweep":
            out["model"] = np.frombuffer(
                checkpoint.dumps_model(args[0], self.family), np.uint8)
        else:
            out.update(proto.pack_tree(args[0], "plan"))
        return out

    def run(self, phase: str, chain_args: List[tuple], accs: list,
            labels_in: bool) -> list:
        """One pass of ``phase`` over every work item on the workers;
        returns ``[acc]``, the partials folded in global block order. A
        sweep first runs ``DistHooks.on_iteration`` with the iteration."""
        import torch

        from repro_torch.core.labelstats import fold_stats
        from repro_torch.kernels.suffstats import STATS_BLOCK
        (args,), (acc,) = chain_args, accs
        coord = self.coord
        if phase == "sweep":
            self._iter = int(args[0].it)
            if coord.hooks.on_iteration is not None:
                coord.hooks.on_iteration(self._iter, coord)
        names = [f.name for f in dataclasses.fields(acc)]
        shapes = [tuple(getattr(acc, f).shape) for f in names]
        state = {"acc": acc, "bytes": 0}

        def fold(lo: int, hi: int, m: dict, arrs: dict) -> None:
            self.labels_h[lo:hi] = arrs["labels"]
            self.sublabels_h[lo:hi] = arrs["sublabels"]
            for e in m.get("io_events", []):
                self.events.append(dict(e, worker=m.get("worker")))
            for k, v in (m.get("launches") or {}).items():
                self.worker_launches[k] = (self.worker_launches.get(k, 0)
                                           + int(v))
            if m.get("peak_bytes") is not None:
                self.worker_peak[m["worker"]] = max(
                    self.worker_peak.get(m["worker"], 0),
                    int(m["peak_bytes"]))
            nb = -(-(hi - lo) // STATS_BLOCK)
            parts = {}
            for i, (name, shape) in enumerate(zip(names, shapes)):
                part = arrs.get(f"p{i}")
                if (part is None or part.shape != (nb,) + shape
                        or part.dtype != np.float32):
                    raise proto.ProtocolError(
                        f"worker partial p{i} for rows [{lo}, {hi}) is "
                        f"{None if part is None else part.shape}, want "
                        f"float32 {(nb,) + shape}: shard out of sync")
                parts[name] = torch.from_numpy(part).to(self.dev)
                state["bytes"] += part.nbytes
            state["acc"] = fold_stats(state["acc"], type(acc)(**parts))

        item_arrays = ((lambda lo, hi: {"labels": self.labels_h[lo:hi],
                                        "sublabels": self.sublabels_h[lo:hi]})
                       if labels_in else None)
        coord.run_phase({"phase": phase,
                         "iter": 0 if phase.startswith("init")
                         else self._iter},
                        self._phase_arrays(phase, args), self.items,
                        item_arrays, fold)
        self.pass_bytes[phase] = state["bytes"]
        return [state["acc"]]

    def buffer_bytes(self, acc_bytes: int) -> int:
        """One work item's partials on the coordinator's device."""
        from repro_torch.kernels.suffstats import STATS_BLOCK
        return acc_bytes * -(-self.item_rows // STATS_BLOCK)

    def labels(self) -> np.ndarray:
        return self.labels_h[None].copy()

    def report(self) -> dict:
        c = self.coord
        return dict(mode="distributed", dist={
            "workers": len(c.workers),
            "shard_ranges": [[int(lo), int(hi)] for lo, hi, _ in self.ranges],
            "work_items": len(self.items),
            "respawns": c.respawns_done,
            "reassignments": c.reassignments,
            "ready_s": c.ready_s,
            "pass_bytes": self.pass_bytes,
            "worker_peak_bytes": self.worker_peak,
            "worker_launches": self.worker_launches,
        })

    def close(self) -> None:
        self.coord.shutdown()
        self._unlink()


def fit_distributed(dpmm, source, iters: int, verbose: bool, keys,
                    init_states=None, hooks: Optional[DistHooks] = None):
    """``DPMM._fit_tiled`` for one chain with its passes on the worker
    processes (``WorkerPasses``). See the module docstring for the bitwise
    and failure contracts. Returns a ``FitResult`` with
    ``mode="distributed"`` and ``dist`` (worker count, shard ranges, work
    items, respawns, reassignments, seconds from spawn to READY, bytes of
    partials a pass, the workers' peak device bytes and launches)."""
    return dpmm._fit_tiled(
        source, iters, verbose, keys, init_states,
        open_passes=lambda events: WorkerPasses(dpmm, source, events,
                                                init_states, hooks))
