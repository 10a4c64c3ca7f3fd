"""The port's tiled (out-of-core) plane and its stat fold, on the CPU.

- ``tile_plan``, ``HostTiledSource`` and ``column_mean`` against the
  reference's (``repro.core.distributed``, ``repro.data.source``): equal.
- The stat fold: the partials of every block added to a nonzero
  accumulator left to right, bitwise a numpy loop (a reduction over the
  block axis first, the order the port used before, is not).
- Tiled fits against resident fits of the same seed (labels, K/score
  history and final stats bitwise equal) for ``gaussian`` and
  ``multinomial`` at N = 3,000 (not a multiple of STATS_BLOCK = 1,024),
  tile sizes 1,024, 2,048 and 1,500 (rounded up to 2,048), from a memmap,
  and through ``FaultInjectingSource``.
- The fault schedule and the retry records against the reference's, and
  the 2^32-point guard.
- One tiled reference fit against a tiled port fit on
  ``generate_gmm(4096, 2, 4)``: NMI >= 0.9 and the same final K. Both run
  with ``burnout=5``: with the default 15, five of the 20 iterations can
  split or merge, too few for the reference's own fit to pass the gate.
- The dense ``suffstats`` oracle's plain version against the reference's
  kernel (interpret mode; at d = 130 its jnp route).
- The CLI with ``--tile-size`` on a .npy file.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs.base import DPMMConfig as JaxConfig
from repro.core import distributed as jdist
from repro.core import resilience as jres
from repro.core.sampler import DPMM as JaxDPMM
from repro.data import faults as jfaults
from repro.data import source as jsource
from repro.kernels import suffstats as jsuffstats
from repro_torch.configs import DPMMConfig
from repro_torch.core import resilience
from repro_torch.core.distributed import tile_plan
from repro_torch.core.family import get_family
from repro_torch.core.labelstats import fold_stats
from repro_torch.core.sampler import DPMM
from repro_torch.data import source
from repro_torch.data.faults import FaultInjectingSource
from repro_torch.data.synthetic import generate_gmm, generate_mnmm
from repro_torch.kernels import ops
from repro_torch.kernels.suffstats import STATS_BLOCK, suffstats_plain
from repro_torch.launch import sample_dpmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


N = 3000
FIT = dict(k_max=16, iters=25, burnout=5, log_every=10)
DATA = {"gaussian": lambda: generate_gmm(N, 2, 4, seed=0),
        "multinomial": lambda: generate_mnmm(N, 16, 4, seed=0)}


@pytest.mark.parametrize("n,tile", [(3000, 1024), (3000, 1500), (3000, None),
                                    (2048, 1024), (1000, 4096), (70_000, None),
                                    (5, 1), (4097, 2048)])
def test_tile_plan_is_the_references(n, tile):
    n_local, tiles = tile_plan(n, 1, tile)
    ref_n, ref_tiles = jdist.tile_plan(n, 1, tile)
    assert (n_local, tiles) == (ref_n, list(ref_tiles))
    assert all(off % STATS_BLOCK == 0 for off, _ in tiles)
    assert sum(length for _, length in tiles) == n


def test_sources_read_and_average_as_the_references(tmp_path):
    x = np.random.default_rng(0).standard_normal((70_000, 3)) * 5 + 2
    np.save(tmp_path / "x.npy", x.astype(np.float32))
    for port, ref in ((source.HostTiledSource(x), jsource.HostTiledSource(x)),
                      (source.HostTiledSource.from_npy(tmp_path / "x.npy"),
                       jsource.HostTiledSource.from_npy(tmp_path / "x.npy")),
                      (source.as_source(x), jsource.as_source(x))):
        for a, b in ((0, 1024), (65_536, 70_100), (69_990, 70_000)):
            np.testing.assert_array_equal(port.read_block(a, b),
                                          ref.read_block(a, b))
        assert port.read_block(69_990, 70_100)[10:].sum() == 0.0
        np.testing.assert_array_equal(port.column_mean(), ref.column_mean())
    assert source.as_source(x).resident() is not None
    assert source.HostTiledSource(x).resident() is None


def test_fold_is_left_to_right_from_the_accumulator():
    rng = np.random.default_rng(1)
    parts = (rng.standard_normal((1000, 8, 2)) * 1e5).astype(np.float32)
    acc = (rng.standard_normal((8, 2)) * 1e5).astype(np.float32)
    want = acc.copy()
    for p in parts:
        want = want + p
    got = ops.fold_partials(torch.from_numpy(acc), torch.from_numpy(parts))
    np.testing.assert_array_equal(got.numpy(), want)
    # the block axis reduced first rounds differently
    block_sum_first = acc + parts.sum(axis=0)
    assert not np.array_equal(block_sum_first, want)
    # a family's label fold from a nonzero accumulator: per-block partials
    fam = get_family("gaussian")
    x = torch.from_numpy(rng.standard_normal((5 * STATS_BLOCK + 7, 3))
                         .astype(np.float32) * 100)
    lab = torch.from_numpy(rng.integers(0, 4, x.shape[0]).astype(np.int32))
    sub = torch.from_numpy(rng.integers(0, 2, x.shape[0]).astype(np.int32))
    valid = torch.ones(x.shape[0])
    acc0 = fam.stats_from_labels(x[:STATS_BLOCK], valid[:STATS_BLOCK],
                                 lab[:STATS_BLOCK], sub[:STATS_BLOCK], 4)
    got = fam.stats_from_labels(x, valid, lab, sub, 4, acc=acc0)
    parts = fam.labels_partials(x, valid, lab, sub, 4)
    for name in ("n", "sx", "sxx"):
        want = getattr(acc0, name).numpy().copy()
        for p in getattr(parts, name).numpy():
            want = want + p
        np.testing.assert_array_equal(getattr(got, name).numpy(), want)
    assert fold_stats(acc0, parts).n.shape == (4, 2)


def _same_chain(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    for key in a.history:
        np.testing.assert_array_equal(a.history[key], b.history[key])
    for name in a.state.stats.__dataclass_fields__:
        assert torch.equal(getattr(a.state.stats, name),
                           getattr(b.state.stats, name)), name
        assert torch.equal(getattr(a.state.substats, name),
                           getattr(b.state.substats, name)), name


@pytest.fixture(scope="module")
def resident():
    out = {}
    for comp, make in DATA.items():
        x, _ = make()
        out[comp] = (x, DPMM(DPMMConfig(component=comp, **FIT),
                             device="cpu").fit(x))
    return out


@pytest.mark.parametrize("comp", sorted(DATA))
@pytest.mark.parametrize("tile", [1024, 2048, 1500])
def test_tiled_fit_is_the_resident_fit(resident, comp, tile):
    x, res = resident[comp]
    assert res.mode == "resident" and res.k >= 2
    tiled = DPMM(DPMMConfig(component=comp, tile_size=tile, **FIT),
                 device="cpu").fit(x)
    assert tiled.mode == "tiled"
    assert tiled.tile_size == -(-tile // STATS_BLOCK) * STATS_BLOCK
    assert tiled.est_peak_bytes > 0 and tiled.recoveries == []
    _same_chain(res, tiled)


def test_tiled_fit_from_a_memmap_is_the_resident_fit(resident, tmp_path):
    x, res = resident["gaussian"]
    np.save(tmp_path / "x.npy", x)
    src = source.HostTiledSource.from_npy(tmp_path / "x.npy")
    assert isinstance(src._x, np.memmap)
    tiled = DPMM(DPMMConfig(**FIT), device="cpu").fit(src)
    assert tiled.mode == "tiled" and tiled.tile_size == N  # default: 64 blocks
    _same_chain(res, tiled)


def test_tiled_fit_through_faults_is_the_resident_fit(resident):
    x, res = resident["multinomial"]
    src = FaultInjectingSource(source.HostTiledSource(x), seed=3, p_io=0.05,
                               p_nan=0.05, p_short=0.05, hang_s=0.0)
    tiled = DPMM(DPMMConfig(component="multinomial", tile_size=1024,
                            io_retries=6, io_backoff_s=0.0, **FIT),
                 device="cpu").fit(src)
    _same_chain(res, tiled)
    faults = [e for e in tiled.recoveries if e["kind"] == "tile_read_fault"]
    assert src.injected and [e["rows"] for e in faults] == [
        f["rows"] for f in src.injected]
    assert {f["kind"] for f in src.injected} == {"io", "nan", "short"}
    retries = [e for e in tiled.recoveries if e["kind"] == "io_retry"]
    assert sum(e["attempts"] - 1 for e in retries) == len(faults)


def test_fault_schedule_and_retry_records_are_the_references():
    x = np.random.default_rng(2).standard_normal((5000, 3)).astype(
        np.float32)
    kw = dict(seed=7, p_io=0.15, p_nan=0.15, p_short=0.15)
    port = FaultInjectingSource(source.HostTiledSource(x), **kw)
    ref = jfaults.FaultInjectingSource(jsource.HostTiledSource(x), **kw)
    ev_p, ev_r = [], []
    pol_p = resilience.RetryPolicy(max_retries=5, backoff_s=0.0)
    pol_r = jres.RetryPolicy(max_retries=5, backoff_s=0.0)
    for a in range(0, 5000, 512):
        np.testing.assert_array_equal(
            resilience.read_block_checked(port, a, a + 512, pol_p,
                                          ev_p.append),
            jres.read_block_checked(ref, a, a + 512, pol_r, ev_r.append))
    assert port.injected == ref.injected and ev_p == ev_r and ev_p
    dead = FaultInjectingSource(source.HostTiledSource(x),
                                schedule=dict.fromkeys(range(10), "io"))
    with pytest.raises(resilience.TileReadError, match=r"\[0, 512\)"):
        resilience.read_block_checked(
            dead, 0, 512, resilience.RetryPolicy(max_retries=2,
                                                 backoff_s=0.0))


class _Huge(source.DataSource):
    n, d = 2 ** 32, 2

    def read_block(self, start, stop):
        raise AssertionError("read before the guard")

    def column_mean(self):
        raise AssertionError("read before the guard")


def test_too_many_points_raise_before_any_read():
    with pytest.raises(ValueError, match="uint32"):
        DPMM(DPMMConfig(tile_size=1024), device="cpu").fit(_Huge())


@pytest.fixture(autouse=True, scope="module")
def jax_tiled_fit():
    """The JAX tiled fit, started on a thread when the module starts: its
    compile runs while the module's port-only tests do, and
    ``test_tiled_fit_matches_the_tiled_reference_fit`` (the module's last
    test) waits for it."""
    x, _ = generate_gmm(4096, 2, 4, seed=0)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: JaxDPMM(JaxConfig(
            iters=20, burnout=5, tile_size=1024)).fit(x))


@pytest.mark.parametrize("n,k,d", [(300, 5, 6), (257, 3, 130)])
def test_dense_suffstats_plain_matches_the_reference_kernel(n, k, d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    resp = rng.dirichlet(np.ones(k), n).astype(np.float32)
    want = jsuffstats.suffstats(jnp.asarray(x), jnp.asarray(resp),
                                interpret=True)
    got = ops.suffstats(torch.from_numpy(x), torch.from_numpy(resp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(
        got, suffstats_plain(torch.from_numpy(x), torch.from_numpy(resp))))


def test_cli_tiled_fit_from_a_file_gives_the_resident_labels(tmp_path):
    x, _ = generate_gmm(2500, 2, 3, seed=4)
    np.save(tmp_path / "x.npy", x)
    out = {}
    for name, extra in (("resident", []), ("tiled", ["--tile-size", "1024"])):
        path = tmp_path / f"{name}.json"
        sample_dpmm.main(["--device", "cpu", "--data-path",
                          str(tmp_path / "x.npy"), "--iters", "20",
                          "--result-path", str(path), *extra])
        out[name] = json.loads(path.read_text())
    assert out["tiled"]["device_bytes"]["mode"] == "tiled"
    assert out["tiled"]["device_bytes"]["tile_size"] == 1024
    assert out["resident"]["device_bytes"]["mode"] == "resident"
    assert out["tiled"]["labels"] == out["resident"]["labels"]


def test_tiled_fit_matches_the_tiled_reference_fit(jax_tiled_fit):
    x, y = generate_gmm(4096, 2, 4, seed=0)
    ref = jax_tiled_fit.result()
    port = DPMM(DPMMConfig(iters=20, burnout=5, tile_size=1024),
                device="cpu").fit(x)
    assert port.mode == ref.device_bytes["mode"] == "tiled"
    assert ref.nmi(y) >= 0.9 and port.nmi(y) >= 0.9, (ref.nmi(y),
                                                       port.nmi(y))
    assert port.k == ref.k
