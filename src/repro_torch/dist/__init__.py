"""Elastic multi-process fits: a coordinator and worker processes.

Port of ``repro.dist``. ``DPMMConfig.workers=N`` routes ``DPMM.fit``
here: a coordinator process (``dist/coordinator.py``) keeps the
``ModelState`` and every O(K) step on its device, and N worker processes
(``dist/worker.py``), on the same card or on the CPU, stream
STATS_BLOCK-aligned row ranges of x and ship their per-block stat partials
back over a framed, CRC-checked socket protocol (``dist/proto.py``). The
chain is the port's single-process tiled fit bit for bit at any worker
count, through a SIGKILL'd or hung worker too.
"""
from repro_torch.dist.coordinator import (Coordinator, DistHooks,
                                          fit_distributed)
from repro_torch.dist.proto import ProtocolError

__all__ = ["Coordinator", "DistHooks", "ProtocolError", "fit_distributed"]
