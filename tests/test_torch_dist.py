"""The port's elastic multi-process fit (repro_torch.dist) on the CPU.

The wire protocol is the reference's, frame for frame: the seven
``tests/test_dist.py`` protocol cases run against the port's copy, and a
message sent by both copies is the same bytes (the zip timestamps pinned).
Then the fit: ``DPMMConfig(workers=2)`` spawns two worker processes
(``device="cpu"``, at most 3 STATS_BLOCKs of rows, tiles of one block)
and must give the port's single-process tiled fit bit for bit — labels,
every history row, every stats, substats and params tensor — for the
gaussian and multinomial families; the same through a SIGKILL'd worker
(its rows requeued, the slot respawned) and through a worker hung on a
read (killed at its deadline, its rows taken by the survivor). With no
survivor and no respawn budget the fit raises ``WorkerLostError`` with
the failover log; a coordinator SIGKILL'd after a rotation save resumes,
still distributed, to the uninterrupted chain; the config, ``n_chains``
and the CLI's ``--workers`` are checked as the reference's.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import zlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.dist import proto as jproto
from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint
from repro_torch.core.distributed import shard_ranges
from repro_torch.core.resilience import WorkerLostError
from repro_torch.core.sampler import DPMM, _split_merge_begin
from repro_torch.data.synthetic import generate_gmm, generate_mnmm
from repro_torch.dist import DistHooks, proto
from repro_torch.dist.proto import ProtocolError
from repro_torch.kernels.suffstats import STATS_BLOCK

N, D, K_MAX = 3000, 4, 16          # 3 STATS_BLOCKs: 2 ranges at 2 workers
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here and so in the workers (the coordinator
    passes its count on): the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def _data(name, n=N):
    if name == "gaussian":
        return generate_gmm(n, D, 4, seed=0, sep=10.0)
    return generate_mnmm(n, 16, 4, seed=0)


def _cfg(name="gaussian", **kw):
    base = dict(component=name, alpha=10.0, iters=6, k_max=K_MAX,
                burnout=2, tile_size=STATS_BLOCK)
    base.update(kw)
    return DPMMConfig(**base)


def _fit(cfg, x, **kw):
    return DPMM(cfg, device="cpu").fit(x, **kw)


@pytest.fixture(scope="module")
def single():
    """The single-process tiled fits the distributed ones must equal."""
    return {name: _fit(_cfg(name), _data(name)[0])
            for name in ("gaussian", "multinomial")}


def _assert_bitwise(a, b, what):
    assert np.array_equal(a.labels, b.labels), f"{what}: labels differ"
    for key in a.history:
        assert np.array_equal(a.history[key], b.history[key]), (
            f"{what}: history[{key}] differs")
    assert a.state.it == b.state.it
    for group in ("stats", "substats", "params", "subparams"):
        ta, tb = getattr(a.state, group), getattr(b.state, group)
        for f in dataclasses.fields(ta):
            assert torch.equal(getattr(ta, f.name), getattr(tb, f.name)), (
                f"{what}: {group}.{f.name} differ")
    for name in ("active", "logweights", "sub_logweights", "stuck"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name))


# ---------------------------------------------------------------------------
# wire protocol: the reference's cases, and the reference's bytes
# ---------------------------------------------------------------------------
def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)             # any hang surfaces as socket.timeout
    return a, b


def _frame(mod=proto, kind="work", meta=None, arrays=None):
    """A valid wire frame of ``mod``'s ``send_msg``, captured."""
    a, b = _pair()
    mod.send_msg(a, kind, meta, arrays)
    a.close()
    chunks = []
    while True:
        c = b.recv(1 << 20)
        if not c:
            break
        chunks.append(c)
    b.close()
    return b"".join(chunks)


def _recv_of(raw):
    """Feed raw bytes then EOF to a recv_msg call (bounded by timeout)."""
    a, b = _pair()
    a.sendall(raw)
    a.close()
    return proto.recv_msg(b)


def test_proto_roundtrip_lossless():
    a, b = _pair()
    arrays = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
              "lab": np.array([1, 2, 3], np.int32),
              "slots": np.array([5, 0, 7], np.int64)}
    proto.send_msg(a, "work", {"lo": 0, "hi": 3}, arrays)
    kind, meta, got = proto.recv_msg(b)
    assert kind == "work" and meta == {"lo": 0, "hi": 3}
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    a.close(), b.close()


def test_proto_frames_are_the_reference_frames(monkeypatch):
    """The same message is the same bytes from both copies (the zip
    members' timestamps pinned: np.savez stamps the current time)."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    msg = ("result", {"lo": 0, "hi": 2048, "io_events": []},
           {"labels": np.arange(5, dtype=np.int32),
            "p0": np.linspace(0, 1, 24, dtype=np.float32).reshape(2, 3, 4)})
    raw = _frame(proto, *msg)
    assert raw == _frame(jproto, *msg)
    assert raw[:4] == proto.MAGIC == jproto.MAGIC
    assert proto.MAX_FRAME_BYTES == jproto.MAX_FRAME_BYTES


def test_proto_tree_roundtrip_keeps_the_plan():
    """A real split/merge plan (bool, int32, int64 and float leaves) over
    the wire and back, field for field and dtype for dtype; a missing
    leaf or a leaf of another dtype is refused."""
    from repro_torch.core.family import get_family
    from repro_torch.core.sampler import _init_model
    from repro_torch.core import gibbs
    fam = get_family("gaussian")
    cfg = _cfg()
    prior = fam.build_prior(cfg, torch.zeros((1, D)))
    model = _init_model(torch.zeros((2,), dtype=torch.int64),
                        *gibbs.finalize_substats(gibbs.empty_substats(
                            fam, K_MAX, D, "cpu")), prior=prior, family=fam,
                        cfg=cfg, k_max=K_MAX)
    plan, _, _ = _split_merge_begin(model, D, prior=prior, family=fam,
                                    cfg=cfg, k_max=K_MAX, k_compact=None)
    packed = proto.pack_tree(plan, "plan")
    a, b = _pair()
    proto.send_msg(a, "phase", {"phase": "sm"}, packed)
    _, _, got = proto.recv_msg(b)
    rebuilt = proto.unpack_tree(plan, got, "plan")
    leaves = proto._leaves(plan)
    assert len(leaves) == len(proto._leaves(rebuilt)) == len(packed)
    for la, lb in zip(leaves, proto._leaves(rebuilt)):
        assert la.numpy().dtype == lb.dtype
        np.testing.assert_array_equal(la.numpy(), lb)
    assert {v.dtype for v in packed.values()} >= {
        np.dtype(np.bool_), np.dtype(np.int32), np.dtype(np.int64)}
    with pytest.raises(ProtocolError, match="missing tree leaf"):
        proto.unpack_tree(plan, dict(list(packed.items())[:-1]), "plan")
    bad = dict(packed, plan1=packed["plan1"].astype(np.int32))
    with pytest.raises(ProtocolError, match="template"):
        proto.unpack_tree(plan, bad, "plan")
    a.close(), b.close()


def test_proto_truncated_frame_raises():
    raw = _frame(arrays={"x": np.ones((8, 8), np.float32)})
    for cut in (3, proto._HEADER.size - 1, proto._HEADER.size + 10,
                len(raw) - 1):
        with pytest.raises(ProtocolError, match="mid-frame"):
            _recv_of(raw[:cut])


def test_proto_bitflip_raises_crc():
    raw = bytearray(_frame(arrays={"x": np.ones((8, 8), np.float32)}))
    raw[proto._HEADER.size + 40] ^= 0x10       # flip one payload bit
    with pytest.raises(ProtocolError, match="CRC mismatch"):
        _recv_of(bytes(raw))


def test_proto_bad_magic_raises():
    raw = bytearray(_frame())
    raw[:4] = b"HTTP"
    with pytest.raises(ProtocolError, match="bad frame magic"):
        _recv_of(bytes(raw))


def test_proto_oversize_length_rejected_before_alloc():
    hdr = proto._HEADER.pack(proto.MAGIC, 0, proto.MAX_FRAME_BYTES + 1)
    with pytest.raises(ProtocolError, match="exceeds cap"):
        _recv_of(hdr)


def test_proto_garbage_payload_raises():
    payload = b"not an npz archive at all"
    raw = proto._HEADER.pack(proto.MAGIC, zlib.crc32(payload),
                             len(payload)) + payload
    with pytest.raises(ProtocolError, match="unparseable"):
        _recv_of(raw)


def test_model_bytes_roundtrip_bitwise_and_checked(single):
    """``dumps_model`` / ``loads_model``: the broadcast of the model to the
    workers is lossless, and a flipped bit is refused."""
    st = single["gaussian"].state
    blob = checkpoint.dumps_model(st, "gaussian")
    back, fam = checkpoint.loads_model(blob, "cpu")
    assert fam.name == "gaussian" and back.it == st.it
    assert torch.equal(back.key.cpu(), st.key.cpu())
    for group in ("stats", "substats", "params", "subparams"):
        for f in dataclasses.fields(getattr(st, group)):
            assert torch.equal(getattr(getattr(back, group), f.name),
                               getattr(getattr(st, group), f.name))
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.loads_model(bytes(bad), "cpu")


# ---------------------------------------------------------------------------
# shard layout and configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,w", [(3000, 2), (3000, 3), (1024, 4), (100, 2),
                                 (5000, 1)])
def test_shard_ranges_block_aligned_cover(n, w):
    r = shard_ranges(n, w, STATS_BLOCK)
    assert r[0][0] == 0 and r[-1][1] == n
    for (l0, h0, _), (l1, _h1, _2) in zip(r, r[1:]):
        assert h0 == l1                      # contiguous cover
        assert h0 % STATS_BLOCK == 0         # cut on the block grid
    assert [slot for *_, slot in r] == list(range(len(r)))
    # more workers than blocks: extras get no range (failover capacity)
    assert len(shard_ranges(100, 4, STATS_BLOCK)) == 1


def test_workers_config_validation():
    assert DPMMConfig().workers is None
    assert (DPMMConfig().worker_deadline_s, DPMMConfig().worker_heartbeat_s,
            DPMMConfig().max_worker_retries) == (120.0, 0.5, 2)
    with pytest.raises(ValueError, match="workers"):
        DPMMConfig(workers=0)
    with pytest.raises(ValueError, match="requires a fixed integer k_max"):
        DPMMConfig(workers=2, k_max="auto")
    with pytest.raises(ValueError, match="worker_deadline_s"):
        DPMMConfig(workers=2, worker_deadline_s=0.0)
    with pytest.raises(ValueError, match="max_worker_retries"):
        DPMMConfig(workers=2, max_worker_retries=-1)


def test_workers_rejects_multichain():
    x, _ = _data("gaussian", n=1024)
    with pytest.raises(ValueError, match="n_chains"):
        _fit(_cfg(workers=2), x, n_chains=2)


# ---------------------------------------------------------------------------
# the distributed chain is the single-process tiled chain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gaussian", "multinomial"])
def test_two_worker_fit_is_the_tiled_fit_bitwise(single, name):
    x, _ = _data(name)
    dist = _fit(_cfg(name, workers=2), x)
    _assert_bitwise(single[name], dist, f"{name} workers=2")
    assert dist.mode == "distributed"
    assert dist.dist["workers"] == 2
    assert dist.dist["shard_ranges"] == [[0, 2048], [2048, N]]
    assert dist.dist["reassignments"] == 0 and dist.recoveries == []
    # a sweep pass ships one block's partials per block
    assert dist.dist["pass_bytes"]["sweep"] > 0


def test_work_items_cut_to_the_stat_windows_bitwise(single, monkeypatch):
    """With the stat window patched down to one block, a tile of two
    blocks spans two windows: the coordinator cuts it into two work items
    (so no item ships more than ``WINDOW_BYTES`` of partials, and no
    RESULT frame nears ``proto.MAX_FRAME_BYTES``), and the chain is still
    the tiled fit's."""
    from repro_torch.core import labelstats
    from repro_torch.core.family import get_family
    one_block = 4 * 2 * K_MAX * get_family("gaussian").slot_floats(D)
    monkeypatch.setattr(labelstats, "WINDOW_BYTES", one_block)
    x, _ = _data("gaussian")
    dist = _fit(_cfg(workers=1, tile_size=2 * STATS_BLOCK), x)
    assert dist.tile_size == 2 * STATS_BLOCK
    assert dist.dist["work_items"] == 3          # [0, 1K) [1K, 2K) [2K, N)
    assert dist.dist["pass_bytes"]["init1"] == 3 * one_block
    _assert_bitwise(single["gaussian"], dist, "windowed work items")


def test_sigkill_failover_bitwise(single):
    """Worker 0 is SIGKILL'd at iteration 2: its rows are requeued to the
    survivor, the slot respawns, and the chain is the clean one."""
    x, _ = _data("gaussian")
    killed = []

    def killer(it, coord):
        if it == 2 and not killed:
            pid = coord.worker_pids()[0]
            os.kill(pid, signal.SIGKILL)
            killed.append(pid)

    dist = _fit(_cfg(workers=2), x, dist_hooks=DistHooks(on_iteration=killer))
    assert killed, "hook never fired"
    _assert_bitwise(single["gaussian"], dist, "sigkill failover")
    ev = [e for e in dist.recoveries if e["kind"] == "worker_failover"]
    assert ev and ev[0]["worker"] == 0 and ev[0]["respawn"]
    assert ev[0]["iter"] == 2
    assert dist.dist["respawns"] >= 1


def test_hang_failover_bitwise(single):
    """Worker 0's first read hangs far past its deadline; heartbeats keep
    flowing, so only the work deadline catches it. The coordinator kills
    it, the survivor takes its rows, and the chain stays clean."""
    x, _ = _data("gaussian")
    hooks = DistHooks(worker_faults={
        0: {"schedule": {0: "hang"}, "hang_s": 600.0}})
    dist = _fit(_cfg(workers=2, worker_deadline_s=2.0,
                     max_worker_retries=0), x, dist_hooks=hooks)
    _assert_bitwise(single["gaussian"], dist, "hang failover")
    ev = [e for e in dist.recoveries if e["kind"] == "worker_failover"]
    assert ev and ev[0]["worker"] == 0
    assert "deadline" in ev[0]["detail"] and ev[0]["phase"] == "init1"
    assert not ev[0]["respawn"]                  # budget was zero
    assert dist.dist["reassignments"] >= 1


def test_worker_lost_error_when_no_survivors():
    """One worker that hangs on every read and no respawn budget: the fit
    fails with the typed error and its failover log."""
    x, _ = _data("gaussian", n=1024)
    hooks = DistHooks(worker_faults={
        0: {"schedule": dict.fromkeys(range(100), "hang"),
            "hang_s": 600.0}})
    with pytest.raises(WorkerLostError, match="no live workers") as ei:
        _fit(_cfg(workers=1, worker_deadline_s=2.0, max_worker_retries=0),
             x, dist_hooks=hooks)
    assert any(e["kind"] == "worker_failover"
               for e in ei.value.recoveries)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a machine without a CUDA device")
def test_worker_that_cannot_start_fails_its_handshake(tmp_path):
    """A worker told to run on the card where none is (or whose kernels
    do not load) reports its error before READY: the coordinator's start
    fails, nothing falls back to the plain path."""
    from repro_torch.dist.coordinator import Coordinator, _HandshakeError
    x, _ = _data("gaussian", n=1024)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    cfg = _cfg(workers=1)
    meta = {"cfg": dataclasses.asdict(cfg), "data_path": path,
            "heartbeat_s": cfg.worker_heartbeat_s, "device": "cuda",
            "item_rows": STATS_BLOCK, "warm": {}}
    with pytest.raises(_HandshakeError, match="CUDA device"):
        Coordinator(cfg, meta, [])


def test_coordinator_sigkill_then_resume_bitwise(tmp_path, single):
    """A coordinator SIGKILL'd right after its second rotation save (its
    workers see EOF and exit) resumes with workers=2 to the uninterrupted
    chain: the same labels and final state, the history its tail."""
    x, _ = _data("gaussian")
    xpath = str(tmp_path / "x.npy")
    np.save(xpath, x)
    pref = str(tmp_path / "kill")
    child = textwrap.dedent(f"""
        import os, signal
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import DPMMConfig
        from repro_torch.core import checkpoint
        from repro_torch.core.sampler import DPMM

        saves = [0]
        real = checkpoint.save_checkpoint
        def dying_save(*a, **kw):
            path = real(*a, **kw)
            saves[0] += 1
            if saves[0] == 2:
                os.kill(os.getpid(), signal.SIGKILL)
            return path
        checkpoint.save_checkpoint = dying_save

        x = np.load({xpath!r}, mmap_mode="r")
        cfg = DPMMConfig(component="gaussian", alpha=10.0, iters=6,
                         k_max={K_MAX}, burnout=2, workers=2,
                         tile_size={STATS_BLOCK},
                         checkpoint_path={pref!r}, checkpoint_every=2)
        DPMM(cfg, device="cpu").fit(x)
        raise SystemExit("fit survived the SIGKILL - test is broken")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH", ""))
         if p])
    env.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stdout, proc.stderr)
    members = checkpoint.list_checkpoints(pref)
    assert members and members[0][0] == 4    # died right after saving it=4
    resumed = _fit(_cfg(workers=2, checkpoint_path=pref,
                        checkpoint_every=2), x, resume=True)
    full = single["gaussian"]
    assert np.array_equal(resumed.labels, full.labels)
    for key in full.history:
        tail = len(resumed.history[key])
        assert tail == 2
        assert np.array_equal(resumed.history[key], full.history[key][-tail:])
    for group in ("stats", "substats"):
        for f in dataclasses.fields(getattr(full.state, group)):
            assert torch.equal(getattr(getattr(resumed.state, group), f.name),
                               getattr(getattr(full.state, group), f.name))


def test_cli_workers_end_to_end(tmp_path):
    from repro_torch.launch import sample_dpmm
    xpath = str(tmp_path / "x.npy")
    x, _ = _data("gaussian")
    np.save(xpath, x)
    params = str(tmp_path / "params.json")
    with open(params, "w") as f:
        json.dump({"k_max": K_MAX, "burnout": 2, "iters": 3,
                   "alpha": 10.0}, f)
    out = str(tmp_path / "result.json")
    sample_dpmm.main(["--data-path", xpath, "--workers", "2",
                      "--tile-size", str(STATS_BLOCK), "--device", "cpu",
                      "--params-path", params, "--result-path", out])
    with open(out) as f:
        res = json.load(f)
    assert len(res["labels"]) == N
    assert res["dist"]["workers"] == 2
    assert res["config"]["workers"] == 2
    assert res["device_bytes"]["mode"] == "distributed"
    assert len(res["iter_times_s"]) == 3
