"""Fault tolerance of the port's fits against the JAX package's.

- config validation: the reference's messages, both packages;
- guardrails read only: a clean chain is bit for bit the one without them,
  on both planes;
- an inf row on the resident plane ends in ``DivergenceError`` with the
  reference's event log (``kind``, ``iter``, ``restored_it``,
  ``rollback``), from one JAX fit on the same data and config;
- a NaN tile let through (``guard_tiles=False``) rolls back once, and the
  fit is then the fit from the anchor under its rekeyed key, bit for bit;
- the rekeyed and chain keys are ``jax.random.fold_in``'s key data;
- a rollback anchor is a deep copy: two more iterations leave it as it was;
- auto-checkpointing saves at the reference's iterations, and
  ``resume=True`` continues bit for bit on both planes, from a torn
  rotation and after a SIGKILL too (a child process that imports no JAX);
- the CLI's ``--checkpoint-every`` / ``--resume``.

Small on purpose (N <= 2000, d = 4, 16 slots, <= 16 iterations, one
torch thread, ``device="cpu"``).
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs import DPMMConfig as JConfig
from repro.core import checkpoint as jckpt
from repro.core import sampler as jsampler
from repro.core.resilience import DivergenceError as JDivergenceError
from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint, sampler
from repro_torch.core.resilience import DivergenceError, model_health
from repro_torch.core.sampler import DPMM
from repro_torch.core.state import clone_model
from repro_torch.data.faults import FaultInjectingSource
from repro_torch.data.source import HostTiledSource
from repro_torch.kernels import prng
from repro_torch.launch import sample_dpmm

N, D, K_MAX = 384, 4, 16
N_TILED, TILE = 2000, 1024          # two tiles a pass, the last partial
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def _data(n: int = N) -> np.ndarray:
    """The reference's resilience data: 4 clusters of spread 8."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, D)) * 8.0
    return (centers[rng.integers(0, 4, n)]
            + rng.normal(size=(n, D))).astype(np.float32)


def _cfg(**kw) -> DPMMConfig:
    base = dict(alpha=2.0, iters=12, k_max=K_MAX, burnout=3, log_every=4)
    base.update(kw)
    return DPMMConfig(**base)


def _fit(cfg, x, iters=None, **kw):
    return DPMM(cfg, device="cpu").fit(x, iters, **kw)


def _leaves(state):
    out = {"key": state.key, "it": torch.as_tensor(state.it)}
    for name in ("active", "logweights", "sub_logweights", "stuck"):
        out[name] = getattr(state, name)
    for group in ("params", "subparams", "stats", "substats"):
        tree = getattr(state, group)
        out.update({f"{group}.{f}": getattr(tree, f)
                    for f in tree.__dataclass_fields__})
    return out


def _assert_same_chain(a, b, history=True):
    np.testing.assert_array_equal(a.labels, b.labels)
    la, lb = _leaves(a.state), _leaves(b.state)
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(la[name].cpu(), lb[name].cpu()), name
    if history:
        for key in a.history:
            np.testing.assert_array_equal(a.history[key], b.history[key])


@pytest.mark.parametrize("kw,match", [
    (dict(checkpoint_every=4), "checkpoint_path"),
    (dict(checkpoint_path="p", checkpoint_every=0), "checkpoint_every"),
    (dict(checkpoint_path="p", checkpoint_keep=0), "checkpoint_keep"),
    (dict(max_recoveries=-1), "max_recoveries"),
    (dict(k_max="auto", tile_size=1024), "resident"),
    (dict(k_max="auto", k_max_cap=0), "k_max_cap"),
    (dict(k_max="auto", k_max_cap=4, init_clusters=5), "init_clusters"),
    (dict(k_block=0), "k_block"),
    (dict(k_max=0), "k_max")])
def test_config_rejects_as_the_reference_does(kw, match):
    for cls in (DPMMConfig, JConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)
    assert DPMMConfig(k_max="auto").k_max_cap == JConfig().k_max_cap == 4096
    for name in ("checkpoint_keep", "guardrails", "max_recoveries",
                 "checkpoint_path", "checkpoint_every"):
        assert getattr(DPMMConfig(), name) == getattr(JConfig(), name)


@pytest.mark.parametrize("plane", ["resident", "tiled"])
def test_guardrails_change_no_bit(plane):
    x = _data()
    kw = {} if plane == "resident" else {"tile_size": 128}
    on = _fit(_cfg(guardrails=True, **kw), x)
    off = _fit(_cfg(guardrails=False, **kw), x)
    assert on.mode == plane
    _assert_same_chain(on, off)
    assert on.recoveries == [] == off.recoveries


@pytest.fixture(autouse=True, scope="module")
def jax_inf_row_fit():
    """The JAX fit of the inf-row data, started on a thread when the
    module starts: its compile runs while the module's port-only tests
    do, and ``test_inf_row_raises_divergence_with_the_reference_event_log``
    (the module's last test) waits for its ``DivergenceError``."""
    x = _data()
    x[5] = np.inf
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: jsampler.DPMM(JConfig(
            alpha=2.0, iters=12, k_max=K_MAX, burnout=3, log_every=4,
            max_recoveries=2)).fit(x))


def test_nan_tile_rolls_back_once_to_the_rekeyed_anchor():
    """Read call 12 is the first tile of the fourth iteration's split/merge
    pass (two init passes and four sweeps before it, two tiles each): its
    NaN rows reach the consistency fold, so the state after 4 iterations is
    unhealthy and the fit goes back to the state after 3 under the key
    ``fold_in(key, 2^30 + 1337 + 1)``."""
    x = _data(N_TILED)
    cfg = _cfg(iters=6, tile_size=TILE, guard_tiles=False)
    src = FaultInjectingSource(HostTiledSource(x), schedule={12: "nan"})
    r = _fit(cfg, src)
    events = [e for e in r.recoveries if e["kind"] == "divergence_rollback"]
    assert [(e["iter"], e["restored_it"], e["rollback"]) for e in events] \
        == [(4, 3, 1)]
    assert len(r.history["k"]) == 6 and len(r.iter_times_s) == 6
    assert bool(model_health(r.state))
    anchor = _fit(cfg, HostTiledSource(x), 3).state
    anchor = anchor.replace(key=torch.tensor(prng.fold_in(
        anchor.key, (1 << 30) + 1337 + 1), dtype=torch.int64))
    replay = _fit(cfg, HostTiledSource(x), 3, init_state=anchor)
    _assert_same_chain(r, replay, history=False)
    np.testing.assert_array_equal(r.history["k"][3:], replay.history["k"])


def test_rekeyed_and_chain_keys_are_jax_key_data():
    key = jax.random.key(7)
    words = tuple(int(v) for v in jax.random.key_data(key))
    jmodel = jsampler.ModelState(key=key, it=0, active=None, logweights=None,
                                 sub_logweights=None, stuck=None, params=None,
                                 subparams=None, stats=None, substats=None)
    model = sampler.ModelState(
        key=torch.tensor(words, dtype=torch.int64), it=0, active=None,
        logweights=None, sub_logweights=None, stuck=None, params=None,
        subparams=None, stats=None, substats=None)
    for n in (1, 2, 3):
        want = jax.random.key_data(jsampler._recovery_rekey(jmodel, n).key)
        got = sampler._recovery_rekey(model, n).key
        assert got.tolist() == np.asarray(want).tolist()
    want = np.asarray(jax.random.key_data(jsampler._chain_keys(key, 5)))
    got = [k.tolist() for k in sampler._chain_keys(words, 5)]
    assert got == want.tolist()


@pytest.mark.parametrize("plane", ["resident", "tiled"])
def test_anchor_is_unchanged_after_two_more_iterations(plane, monkeypatch):
    """Each anchor the fit takes (``clone_model``) is held as numpy copies
    of its tensors when taken, and compared when the fit has run two more
    iterations."""
    taken = []
    real = clone_model

    def spy(model):
        copy = real(model)
        taken.append((copy, {k: v.clone() for k, v in _leaves(copy).items()}))
        return copy
    monkeypatch.setattr(sampler, "clone_model", spy)
    kw = dict(log_every=1)
    if plane == "tiled":
        kw["tile_size"] = TILE
    _fit(_cfg(iters=8, **kw), _data(N_TILED))
    assert len(taken) == 9           # the start, then every iteration
    for copy, values in taken[:-2]:
        for name, v in _leaves(copy).items():
            assert torch.equal(v, values[name]), name


def _reference_members(cfg: DPMMConfig, boundaries, monkeypatch):
    """The iterations the reference's ``_Recovery`` saves at, given the
    boundaries it is called at (then the forced save at the last)."""
    saved = []
    monkeypatch.setattr(jckpt, "save_checkpoint",
                        lambda prefix, model, fam, it, keep: saved.append(it))
    rec = jsampler._Recovery(cfg, "gaussian", 0)
    for b in boundaries:
        rec.maybe_checkpoint(None, b)
    rec.maybe_checkpoint(None, boundaries[-1], force=True)
    return saved


@pytest.mark.parametrize("plane", ["resident", "tiled"])
def test_auto_checkpoint_then_resume_is_the_uninterrupted_fit(
        plane, tmp_path, monkeypatch):
    x = _data(N_TILED)
    kw = dict(log_every=3) if plane == "resident" else dict(tile_size=TILE)
    pref = str(tmp_path / "ck")
    saved = []
    real = checkpoint.save_checkpoint
    monkeypatch.setattr(checkpoint, "save_checkpoint", lambda *a, **k: (
        saved.append(a[3]), real(*a, **k))[1])
    cfg = _cfg(checkpoint_path=pref, checkpoint_every=4, **kw)
    first = _fit(cfg, x, 8)                      # "killed" after 8
    bounds = [3, 6, 8] if plane == "resident" else list(range(1, 9))
    assert saved == _reference_members(cfg, bounds, monkeypatch)
    assert saved == ([6, 8] if plane == "resident" else [4, 8])
    resumed = _fit(cfg, x, 14, resume=True)      # the total target
    whole = _fit(_cfg(**kw), x, 14)
    assert resumed.state.it == 14 and len(resumed.history["k"]) == 6
    _assert_same_chain(resumed, whole, history=False)
    for key in whole.history:
        np.testing.assert_array_equal(
            np.concatenate([first.history[key], resumed.history[key]]),
            whole.history[key])
    assert checkpoint.list_checkpoints(pref)[0][0] == 14


def test_resume_without_a_member_is_a_fresh_fit(tmp_path):
    x = _data()
    cfg = _cfg(checkpoint_path=str(tmp_path / "empty"), checkpoint_every=4)
    _assert_same_chain(_fit(cfg, x, 8, resume=True), _fit(_cfg(), x, 8))


def test_resume_falls_back_past_a_torn_member(tmp_path):
    x = _data()
    pref = str(tmp_path / "ck")
    cfg = _cfg(checkpoint_path=pref, checkpoint_every=4)
    _fit(cfg, x, 8)
    newest = checkpoint.list_checkpoints(pref)[0][1]
    blob = open(newest, "rb").read()
    open(newest, "wb").write(blob[:len(blob) // 2])       # torn write
    resumed = _fit(cfg, x, 12, resume=True)               # from it = 4
    assert len(resumed.history["k"]) == 8
    _assert_same_chain(resumed, _fit(_cfg(), x, 12), history=False)


def test_resume_refuses_init_state_a_missing_prefix_and_another_family(
        tmp_path):
    x = _data()
    state = _fit(_cfg(), x, 2).state
    with pytest.raises(ValueError, match="checkpoint_path"):
        _fit(_cfg(), x, 4, resume=True)
    cfg = _cfg(checkpoint_path=str(tmp_path / "ck"), checkpoint_every=2)
    with pytest.raises(ValueError, match="not both"):
        _fit(cfg, x, 4, resume=True, init_state=state)
    _fit(cfg, x, 2)
    other = _cfg(component="multinomial",
                 checkpoint_path=str(tmp_path / "ck"), checkpoint_every=2)
    with pytest.raises(ValueError, match="'gaussian' model"):
        _fit(other, np.abs(x), 4, resume=True)
    with pytest.raises(ValueError, match="n_chains"):
        _fit(_cfg(), x, 1, n_chains=2, init_state=state)
    with pytest.raises(ValueError, match="n_chains must be"):
        _fit(_cfg(), x, 1, n_chains=0)


def test_sigkilled_fit_resumes_bitwise(tmp_path):
    """A child fit (no JAX) SIGKILLs itself right after its second rotation
    save; the parent resumes from the rotation to the uninterrupted
    chain."""
    x = _data()
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
        cfg = DPMMConfig(alpha=2.0, iters=16, k_max={K_MAX}, burnout=3,
                         log_every=4, checkpoint_path={pref!r},
                         checkpoint_every=4)
        DPMM(cfg, device="cpu").fit(np.load({xpath!r}))
        raise SystemExit("the fit survived its SIGKILL")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH", ""))
        if p)
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-2000:])
    members = checkpoint.list_checkpoints(pref)
    assert members and members[0][0] == 8
    cfg = _cfg(checkpoint_path=pref, checkpoint_every=4)
    resumed = _fit(cfg, x, 16, resume=True)
    _assert_same_chain(resumed, _fit(_cfg(), x, 16), history=False)


def test_cli_resumes_a_stopped_run(tmp_path, monkeypatch):
    """``--checkpoint-every 4 --iters 12``, stopped right after its first
    member, then the same command with ``--resume``: the labels of the run
    that was never stopped."""
    base = ["--n", "600", "--d", "3", "--k", "3", "--iters", "12",
            "--device", "cpu", "--params-path", str(tmp_path / "p.json")]
    (tmp_path / "p.json").write_text(json.dumps(
        dict(k_max=K_MAX, burnout=3, log_every=4)))
    whole = tmp_path / "whole.json"
    sample_dpmm.main(base + ["--result-path", str(whole)])

    class Stop(Exception):
        pass
    real = checkpoint.save_checkpoint

    def stop_after_first(*a, **kw):
        real(*a, **kw)
        raise Stop
    monkeypatch.setattr(checkpoint, "save_checkpoint", stop_after_first)
    ck = ["--checkpoint-path", str(tmp_path / "ck"), "--checkpoint-every",
          "4", "--result-path", str(tmp_path / "r.json")]
    with pytest.raises(Stop):
        sample_dpmm.main(base + ck)
    monkeypatch.setattr(checkpoint, "save_checkpoint", real)
    assert [it for it, _ in checkpoint.list_checkpoints(
        str(tmp_path / "ck"))] == [4]
    sample_dpmm.main(base + ck + ["--resume"])
    got = json.loads((tmp_path / "r.json").read_text())
    assert got["labels"] == json.loads(whole.read_text())["labels"]
    assert len(got["iter_times_s"]) == 8


def test_inf_row_raises_divergence_with_the_reference_event_log(
        jax_inf_row_fit):
    x = _data()
    x[5] = np.inf                    # persistent: rollback is futile
    with pytest.raises(DivergenceError) as got:
        _fit(_cfg(max_recoveries=2), x)
    with pytest.raises(JDivergenceError) as want:
        jax_inf_row_fit.result()
    fields = ("kind", "iter", "restored_it", "rollback")
    events = [tuple(e[f] for f in fields) for e in got.value.recoveries]
    assert events == [tuple(e[f] for f in fields)
                      for e in want.value.recoveries]
    assert len(events) == 3          # max_recoveries + the last straw
