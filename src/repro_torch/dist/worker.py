"""Worker process of the elastic multi-process fit (repro_torch.dist).

Port of ``repro.dist.worker``. A worker owns nothing but a row-range view
of x behind the ``DataSource`` protocol (``HostTiledSource.from_npy``, a
memory map of the fit's .npy) and a socket to the coordinator. It is
stateless: the model lives on the coordinator, labels are recomputed
every sweep, and each WORK message names its rows, so any worker (a
survivor or a respawn) recomputes any block to the same bits.

Per WORK message the worker reads its rows (one work item: at most a
tile, and at most one stat window of the dense slab, STATS_BLOCK-aligned)
through ``read_block_checked``, so transient I/O faults retry here and
their events ride back to the coordinator's ``FitResult.recoveries``, and
runs the phase's ``sampler.tile_body`` on them on its device: the body
the single-process tiled fit runs on each tile. The phases and what their
broadcast carries:

- ``init1``: nothing (round-robin labels over ``k_max``);
- ``init2``: the initial means and hyperplanes;
- ``sweep``: the model after steps (a)-(d), drawn on the coordinator; the
  keys of steps (e) and (f) come from its ``(key, it)``; a
  ``CompactionPlan`` when the sweep runs on a compact slab;
- ``sm``: the split/merge plan, and its ``CompactionPlan``.

The body runs with ``acc=None`` and returns the kernels' per-STATS_BLOCK
stat partials unfolded; the worker ships them with the labels and
sub-labels, and the coordinator folds them in global block order. So a
worker's compute is the single-process tiled fit's, bit for bit, on the
same device and thread count (``threads`` of the init message, on the
CPU).

On the card the worker only loads the kernels (``build.load_all``): its
coordinator built them before it spawned it, and a worker that cannot
load them fails its handshake (an ``error`` message before READY); it
never falls back to the plain versions. ``warmup`` then runs every phase
once at the fit's shapes, so a work deadline bounds compute, not module
loading. A daemon thread heartbeats every ``worker_heartbeat_s``, so the
coordinator tells a hung worker (beats flowing, deadline missed) from a
dead one (EOF). Each RESULT also carries the kernels' launches for its
rows and the process's peak device bytes.

Run as: ``python -m repro_torch.dist.worker --connect HOST:PORT --id w0
[--device cuda|cpu]`` (the init message's device wins; default cuda).
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import traceback
from typing import Dict, List, Optional

import numpy as np

from repro_torch.dist import proto


class WorkerRuntime:
    """Shard-local compute: the tiled fit's tile bodies on one device,
    over the rows each WORK message names."""

    def __init__(self, meta: dict, device: str = "cuda"):
        # torch and the port load here, not at module import: the entry
        # point's argument parsing and the protocol stay light
        import torch

        from repro_torch.configs import DPMMConfig
        from repro_torch.core.family import get_family
        from repro_torch.core.resilience import RetryPolicy
        from repro_torch.core.sampler import resolve_device
        from repro_torch.data.faults import FaultInjectingSource
        from repro_torch.data.source import HostTiledSource
        from repro_torch.kernels import build

        self._torch = torch
        self.device = resolve_device(meta.get("device") or device)
        if self.device.type == "cuda":
            build.load_all()
        elif meta.get("threads"):
            torch.set_num_threads(int(meta["threads"]))
        cfg = DPMMConfig(**meta["cfg"])
        self.cfg = cfg
        self.family = get_family(cfg.component)
        src = HostTiledSource.from_npy(meta["data_path"])
        faults = meta.get("faults")
        if faults:
            fa = dict(faults)
            if fa.get("schedule"):
                # the JSON round trip made the call-index keys strings
                fa["schedule"] = {int(k): v
                                  for k, v in fa["schedule"].items()}
            src = FaultInjectingSource(src, **fa)
        self.source = src
        self.n, self.d = src.n, src.d
        self.item_rows = int(meta["item_rows"])
        self.ones = torch.ones((self.item_rows,), dtype=torch.float32,
                               device=self.device)
        self.retry = RetryPolicy(max_retries=cfg.io_retries,
                                 backoff_s=cfg.io_backoff_s,
                                 guard_nonfinite=cfg.guard_tiles)
        self._warm = meta.get("warm") or {}
        self._phase: Optional[str] = None
        self._args: Optional[tuple] = None
        self.plan_tpl = None

    # -- helpers -------------------------------------------------------------
    def _tensor(self, a: np.ndarray):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # a memory-mapped source's rows
            a = a.copy()
        return self._torch.from_numpy(a).to(self.device)

    def _tree(self, tree):
        """A tree of numpy leaves (``proto.unpack_tree``) on the device."""
        import dataclasses
        return type(tree)(**{
            f.name: (self._tree(v) if dataclasses.is_dataclass(v)
                     else self._tensor(v))
            for f in dataclasses.fields(tree)
            for v in (getattr(tree, f.name),)})

    def _sweep_args(self, model, comp) -> tuple:
        """``tile_body``'s sweep arguments: the model, with the key words
        of steps (e) and (f) derived from its ``(key, it)`` as
        ``gibbs.sweep_begin`` derives them."""
        from repro_torch.core import gibbs
        from repro_torch.kernels import prng
        model = model.replace(key=model.key.cpu())
        keys = gibbs.sweep_keys(model)
        return (model, prng.key_tensor(keys[4], self.device),
                prng.key_tensor(keys[5], self.device), comp)

    # -- phases --------------------------------------------------------------
    def set_phase(self, meta: dict, arrays: Dict[str, np.ndarray]) -> None:
        """The phase's ``tile_body`` arguments from its broadcast."""
        from repro_torch.core import checkpoint, gibbs
        phase = meta["phase"]
        comp = (gibbs.CompactionPlan(self._tensor(arrays["comp0"]),
                                     self._tensor(arrays["comp1"]))
                if "comp0" in arrays else None)
        if phase == "sweep":
            model, _ = checkpoint.loads_model(arrays["model"].tobytes(),
                                              self.device)
            self._args = self._sweep_args(model, comp)
        elif phase == "sm":
            self._args = (self._tree(proto.unpack_tree(
                self.plan_tpl, arrays, "plan")), comp)
        elif phase == "init2":
            self._args = (self._tensor(arrays["means0"]),
                          self._tensor(arrays["v0"]))
        elif phase == "init1":
            self._args = ()
        else:
            raise proto.ProtocolError(f"unknown phase {phase!r}")
        self._phase = phase

    def _body(self, x, off: int, lab, sub):
        """The current phase's ``tile_body`` on rows ``off..off + len(x)``,
        its stat partials unfolded."""
        from repro_torch.core.sampler import tile_body
        if self._phase is None:
            raise proto.ProtocolError("WORK before PHASE")
        return tile_body(self._phase, self._args, x, off,
                         self.ones[:x.shape[0]], lab, sub, None,
                         self.family, self.cfg)

    def process(self, meta: dict, arrays: Dict[str, np.ndarray]):
        """Run the current phase over rows [lo, hi) (at most ``item_rows``
        of them); returns the RESULT (meta, arrays): labels, sub-labels,
        every stat field's per-block partials (``p0``, ``p1``, ... in field
        order), the local I/O recovery events, the kernels' launches and
        the peak device bytes."""
        import dataclasses
        from repro_torch.core.resilience import read_block_checked
        from repro_torch.kernels import ops
        torch = self._torch
        lo, hi = int(meta["lo"]), int(meta["hi"])
        if not 0 < hi - lo <= self.item_rows:
            raise proto.ProtocolError(
                f"work item [{lo}, {hi}) is not 1..{self.item_rows} rows")
        io_events: List[dict] = []
        before = ops.launch_counts()
        x = self._tensor(read_block_checked(self.source, lo, hi, self.retry,
                                            on_event=io_events.append))
        lab = sub = None
        if "labels" in arrays:
            lab = self._tensor(arrays["labels"])
            sub = self._tensor(arrays["sublabels"])
        lab, sub, parts = self._body(x, lo, lab, sub)
        out = {"labels": lab.cpu().numpy(), "sublabels": sub.cpu().numpy()}
        for i, f in enumerate(dataclasses.fields(parts)):
            out[f"p{i}"] = getattr(parts, f.name).cpu().numpy()
        after = ops.launch_counts()
        peak = (int(torch.cuda.max_memory_allocated(self.device))
                if self.device.type == "cuda" else None)
        return ({"lo": lo, "hi": hi, "phase": self._phase,
                 "io_events": io_events, "peak_bytes": peak,
                 "launches": {k: after[k] - before[k] for k in after}}, out)

    # -- warmup --------------------------------------------------------------
    def warmup(self) -> None:
        """Run every phase once at the fit's shapes (one work item, the
        dense slab and the slabs the init message names), so the first
        WORK does not load kernel modules under its deadline; and build
        the split/merge plan template from a plan the sampler's own code
        makes, so the wire's dtypes are checked against it."""
        from repro_torch.core import checkpoint, gibbs
        from repro_torch.core.sampler import (_init_model,
                                              _split_merge_begin)
        torch, cfg, fam, dev = self._torch, self.cfg, self.family, self.device
        k_max, d = cfg.k_max, self.d
        prior = fam.build_prior(cfg, torch.zeros((1, d), device=dev))
        empty = gibbs.empty_substats(fam, k_max, d, dev)
        model = _init_model(torch.zeros((2,), dtype=torch.int64),
                            *gibbs.finalize_substats(empty), prior=prior,
                            family=fam, cfg=cfg, k_max=k_max)
        plan, _, _ = _split_merge_begin(model, d, prior=prior, family=fam,
                                        cfg=cfg, k_max=k_max, k_compact=None)
        self.plan_tpl = proto.unpack_tree(
            plan, proto.pack_tree(plan, "plan"), "plan")
        # the model and the plan as the wire delivers them (contiguous)
        model, _ = checkpoint.loads_model(
            checkpoint.dumps_model(model, fam), dev)
        plan = self._tree(self.plan_tpl)
        length = min(self.item_rows, self.n)
        x = torch.ones((length, d), device=dev)
        lab = torch.zeros((length,), dtype=torch.int32, device=dev)
        comp = lambda k_c: (None if k_c is None or k_c >= k_max else
                            gibbs.compaction_plan(model.active, int(k_c)))
        runs = [("init1", ()),
                ("init2", (torch.zeros((k_max, d), device=dev),
                           torch.ones((k_max, d), device=dev)))]
        runs += [("sweep", self._sweep_args(model, comp(k_c)))
                 for k_c in [None] + list(self._warm.get("sweep_k") or [])]
        runs += [("sm", (plan, comp(k_c)))
                 for k_c in [None] + list(self._warm.get("sm_k") or [])]
        for phase, args in runs:
            self._phase, self._args = phase, args
            self._body(x, 0, lab, lab)
        self._phase = self._args = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Process entry: HELLO -> INIT -> warmup -> READY -> {PHASE | WORK}* loop
# ---------------------------------------------------------------------------
def _heartbeat_loop(sock, lock, interval: float,
                    stop: threading.Event) -> None:
    while not stop.wait(interval):
        try:
            proto.send_msg(sock, "heartbeat", lock=lock)
        except OSError:
            return                      # coordinator gone; main loop exits


def run_worker(sock, worker_id: str, device: str = "cuda") -> int:
    lock = threading.Lock()
    stop = threading.Event()
    try:
        proto.send_msg(sock, "hello", {"id": worker_id}, lock=lock)
        kind, meta, _ = proto.recv_msg(sock)
        if kind != "init":
            raise proto.ProtocolError(f"expected init, got {kind!r}")
        threading.Thread(
            target=_heartbeat_loop,
            args=(sock, lock, float(meta.get("heartbeat_s", 0.5)), stop),
            daemon=True).start()
        rt = WorkerRuntime(meta, device)
        rt.warmup()
        proto.send_msg(sock, "ready", {"id": worker_id}, lock=lock)
        while True:
            kind, meta, arrays = proto.recv_msg(sock)
            if kind == "phase":
                rt.set_phase(meta, arrays)
            elif kind == "work":
                out_meta, out_arrays = rt.process(meta, arrays)
                out_meta["worker"] = worker_id
                proto.send_msg(sock, "result", out_meta, out_arrays,
                               lock=lock)
            elif kind == "shutdown":
                return 0
            # unknown kinds are ignored (forward compatibility)
    except (proto.ProtocolError, OSError):
        # the coordinator died or the stream broke: nothing to clean up
        # (shards are stateless); exit nonzero so ps tells the story
        return 1
    except Exception:
        # a compute-side failure (kernels that do not load, a TileReadError
        # past the retry budget): tell the coordinator why before dying,
        # so the failover event or the failed handshake carries it
        try:
            proto.send_msg(sock, "error",
                           {"id": worker_id,
                            "detail": traceback.format_exc(limit=5)},
                           lock=lock)
        except OSError:
            pass
        return 2
    finally:
        stop.set()
        try:
            sock.close()
        except OSError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch.dist worker shard (spawned by the "
                    "coordinator)")
    ap.add_argument("--connect", required=True,
                    help="coordinator host:port")
    ap.add_argument("--id", default="w?", help="worker slot id")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (kernels, default) or 'cpu'; the "
                         "coordinator's init message overrides it")
    args = ap.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=60)
    sock.settimeout(None)
    proto.no_delay(sock)
    return run_worker(sock, args.id, args.device)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # skip the interpreter's teardown (a second of torch's at exit): the
    # worker holds no state worth finalising
    os._exit(code)
