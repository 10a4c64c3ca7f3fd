"""The port's device mesh on the CPU (``repro_torch.core.distributed``,
``DPMM(cfg, mesh=...)``), held to the contracts of the reference's mesh
tests (``tests/test_distributed_dpmm.py``, ``tests/test_tiled_parity.py``)
with logical shards: a ``Mesh`` that names the CPU several times.

- ``tile_plan`` and ``pad_to_multiple`` equal the reference's over ragged
  N, 1-4 shards and several tile sizes;
- each shard's global point indices equal the reference's
  ``global_indices`` under ``shard_map`` over the 4 virtual CPU devices of
  ``tests/conftest.py``;
- the one cross-shard reduction (``reduce_stats``) is a numpy left-to-right
  fold in shard order from zero, bit for bit, and the reference's psum
  (``finalize_substats``) within 1e-6 relative;
- a one-shard mesh fit is the plain one-device fit bit for bit;
- 4 shards against 1 at ``generate_gmm(4096, 4, 5)``, at a ragged
  N = 4100 and at N = 4097 (3 padded rows of ``valid = 0``): labels and
  every history but
  ``score`` equal, ``score`` within rtol 1e-3 / atol 1.0 (the reference's
  cross-mesh contract: the reduction sums in another order);
- per mesh the tiled chain is the resident one bit for bit;
- a reduction gathers G K 2 T 4 bytes whatever N;
- on a 2-shard mesh ``fit(resume=True)`` from a rotation and chain c of
  ``n_chains=2`` are bitwise the uninterrupted and the single fit, and
  ``k_max='auto'`` and the guardrails' rollback compose with the mesh.

No JAX fit runs here: the reference is held only in its small pieces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.core import distributed as jdist
from repro.core import gibbs as jgibbs
from repro.core import niw as jniw
from repro.core.family import get_family as jget_family
from repro_torch.configs import DPMMConfig
from repro_torch.core import distributed, gibbs
from repro_torch.core.distributed import Mesh
from repro_torch.core.family import get_family
from repro_torch.core.niw import GaussStats
from repro_torch.core.resilience import DivergenceError
from repro_torch.core.sampler import DPMM
from repro_torch.data.source import HostTiledSource
from repro_torch.data.synthetic import generate_gmm, generate_mnmm
from repro_torch.kernels import prng
from repro_torch.kernels.suffstats import STATS_BLOCK

FIT = dict(alpha=10.0, k_max=16, iters=20, burnout=5, log_every=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def cpu_mesh(g: int) -> Mesh:
    return Mesh(["cpu"] * g, ("data",))


def _same_chain(a, b, what=""):
    np.testing.assert_array_equal(a.labels, b.labels, err_msg=what)
    for key in a.history:
        np.testing.assert_array_equal(a.history[key], b.history[key],
                                      err_msg=f"{what} {key}")
    for group in ("stats", "substats"):
        sa, sb = getattr(a.state, group), getattr(b.state, group)
        for name in sa.__dataclass_fields__:
            assert torch.equal(getattr(sa, name), getattr(sb, name)), (
                what, group, name)


@pytest.mark.parametrize("n", [1, 1000, 1024, 3000, 4097, 70_001])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_layout_is_the_references(n, shards):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    for tile in (None, 1, 1024, 1536):
        got = distributed.tile_plan(n, shards, tile)
        want = jdist.tile_plan(n, shards, tile)
        assert (got[0], got[1]) == (want[0], list(want[1])), tile
        assert all(off % STATS_BLOCK == 0 for off, _ in got[1])
        assert sum(length for _, length in got[1]) == got[0]
    xp, valid = distributed.pad_to_multiple(x, shards)
    jxp, jvalid = jdist.pad_to_multiple(x, shards)
    np.testing.assert_array_equal(xp, jxp)
    np.testing.assert_array_equal(valid, jvalid)


def test_global_indices_are_the_references():
    assert jax.device_count() == 4, "tests/conftest.py sets 4 devices"
    mesh = jdist.make_data_mesh(4)
    n = 4100
    n_local = -(-n // 4)
    for off, length in ((0, n_local), (0, 512), (512, n_local - 512)):
        ref = jax.jit(jdist.shard_map(
            lambda: jgibbs.global_indices(n_local, ("data",), offset=off,
                                          length=length),
            mesh=mesh, in_specs=(), out_specs=jax.sharding.PartitionSpec(
                "data")))()
        xs, _ = distributed.shard_points(cpu_mesh(4),
                                         np.zeros((n, 3), np.float32))
        port = np.concatenate([
            gibbs.global_indices(length, "cpu", s * n_local + off).numpy()
            for s in range(len(xs))])
        np.testing.assert_array_equal(port, np.asarray(ref).astype(np.int64))
        assert all(x.shape == (n_local, 3) for x in xs)


def _shard_stats(rng, g, k, d):
    return [GaussStats(
        n=torch.from_numpy(rng.integers(0, 500, (k, 2)).astype(np.float32)),
        sx=torch.from_numpy((rng.standard_normal((k, 2, d)) * 1e3)
                            .astype(np.float32)),
        sxx=torch.from_numpy((rng.standard_normal((k, 2, d, d)) * 1e5)
                             .astype(np.float32))) for _ in range(g)]


def test_reduction_is_the_ordered_fold_and_the_references_psum():
    rng = np.random.default_rng(3)
    fam = get_family("gaussian")
    g, k, d = 4, 8, 3
    parts = _shard_stats(rng, g, k, d)
    distributed.reset_reduce_counts()
    got = distributed.reduce_stats(fam, parts, torch.device("cpu"))
    counts = distributed.reduce_counts()
    assert counts == {"reductions": 1,
                      "bytes": g * k * 2 * (1 + d + d * d) * 4}
    for name in ("n", "sx", "sxx"):
        want = np.zeros_like(getattr(parts[0], name).numpy())
        for p in parts:
            want = want + getattr(p, name).numpy()
        np.testing.assert_array_equal(getattr(got, name).numpy(), want)
    # the reference's one psum over the data axis, then the l/r fold
    mesh = jdist.make_data_mesh(4)
    spec = jax.sharding.PartitionSpec("data")
    stacked = jniw.GaussStats(*[jnp.stack([getattr(p, f).numpy()
                                           for p in parts])
                                for f in ("n", "sx", "sxx")])
    ref = jax.jit(jdist.shard_map(
        lambda s: jgibbs.finalize_substats(
            jget_family("gaussian"), jax.tree.map(lambda a: a[0], s),
            ("data",)),
        mesh=mesh, in_specs=(spec,),
        out_specs=jax.sharding.PartitionSpec()))(stacked)
    stats, _ = gibbs.finalize_substats(got)
    for name in ("n", "sx", "sxx"):
        want = np.asarray(getattr(ref[1], name))
        np.testing.assert_allclose(getattr(got, name).numpy(), want,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(getattr(stats, name).numpy(),
                                   np.asarray(getattr(ref[0], name)),
                                   rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    # one shard: no reduction
    assert distributed.reduce_stats(fam, parts[:1], "cpu") is parts[0]
    assert distributed.reduce_counts()["reductions"] == 1


@pytest.mark.parametrize("component", ["gaussian", "multinomial"])
def test_one_shard_mesh_is_the_plain_fit(component):
    x, _ = (generate_gmm(3000, 2, 4, seed=0) if component == "gaussian"
            else generate_mnmm(3000, 16, 4, seed=0))
    cfg = DPMMConfig(component=component, **FIT)
    plain = DPMM(cfg, device="cpu").fit(x)
    mesh = DPMM(cfg, mesh=cpu_mesh(1)).fit(x)
    _same_chain(plain, mesh, component)
    assert mesh.mesh["data_shards"] == 1 and mesh.mesh["reductions"] == 0
    assert plain.mesh["reduce_bytes"] == 0


@pytest.mark.parametrize("n", [4096, 4100, 4097])
def test_four_shards_hold_the_cross_mesh_contract(n):
    x, y = generate_gmm(n, 4, 5, seed=0, sep=10.0)
    cfg = DPMMConfig(alpha=10.0, iters=30, k_max=16, burnout=5)
    one = DPMM(cfg, mesh=cpu_mesh(1)).fit(x)
    four = DPMM(cfg, mesh=cpu_mesh(4)).fit(x)
    assert four.mesh["data_shards"] == 4
    assert four.mesh["n_local"] == -(-n // 4)
    assert four.labels.shape == (n,)
    differ = np.nonzero(one.labels != four.labels)[0]
    assert differ.size == 0, (
        f"{differ.size} labels differ between 1 and 4 shards: "
        f"{differ[:10]}")
    assert one.k == four.k
    for key in one.history:
        if key == "score":
            np.testing.assert_allclose(one.history[key], four.history[key],
                                       rtol=1e-3, atol=1.0)
        else:
            np.testing.assert_array_equal(one.history[key],
                                          four.history[key], err_msg=key)
    assert four.nmi(y) > 0.9


def test_tiled_is_the_resident_chain_per_mesh():
    x, _ = generate_gmm(3001, 2, 4, seed=1)       # one padded row
    mesh = cpu_mesh(2)
    resident = DPMM(DPMMConfig(**FIT), mesh=mesh).fit(x)
    tiled = DPMM(DPMMConfig(tile_size=STATS_BLOCK, **FIT),
                 mesh=mesh).fit(HostTiledSource(x))
    _same_chain(resident, tiled, "2 shards")
    assert tiled.mode == "tiled" and tiled.mesh["data_shards"] == 2
    assert tiled.mesh["reductions"] == resident.mesh["reductions"]
    assert tiled.mesh["reduce_bytes"] == resident.mesh["reduce_bytes"]


def test_reduction_bytes_are_o_kt_whatever_n():
    cfg = DPMMConfig(alpha=10.0, k_max=8, iters=6, burnout=2,
                     compact=False)
    g, d = 2, 3
    per = g * cfg.k_max * 2 * (1 + d + d * d) * 4
    seen = []
    for n in (1024, 8192):
        x, _ = generate_gmm(n, d, 3, seed=2)
        r = DPMM(cfg, mesh=cpu_mesh(g)).fit(x)
        # two init passes, a sweep each iteration, a move after burnout
        assert r.mesh["reductions"] == 2 + 6 + 4
        assert r.mesh["reduce_bytes"] == r.mesh["reductions"] * per
        seen.append(r.mesh["reduce_bytes"])
    assert seen[0] == seen[1]


def test_resume_and_chains_on_a_two_shard_mesh(tmp_path):
    x, _ = generate_gmm(2500, 2, 3, seed=4)
    mesh = cpu_mesh(2)
    cfg = DPMMConfig(**FIT)
    whole = DPMM(cfg, mesh=mesh).fit(x)
    rot = DPMMConfig(checkpoint_path=str(tmp_path / "run"),
                     checkpoint_every=5, **FIT)
    DPMM(rot, mesh=mesh).fit(x, 12)
    rest = DPMM(rot, mesh=mesh).fit(x, FIT["iters"], resume=True)
    np.testing.assert_array_equal(rest.labels, whole.labels)
    for key in whole.history:        # the final save was at iteration 12
        np.testing.assert_array_equal(rest.history[key],
                                      whole.history[key][12:])
    for name in ("n", "sx", "sxx"):
        assert torch.equal(getattr(rest.state.stats, name),
                           getattr(whole.state.stats, name))
    multi = DPMM(DPMMConfig(**dict(FIT, iters=10)), mesh=mesh).fit(
        x, n_chains=2)
    single = DPMM(DPMMConfig(**dict(FIT, iters=10)), mesh=mesh).fit(
        x, key=prng.fold_in((0, 0), 1))
    _same_chain(multi.chain(1), single, "chain 1")
    assert multi.labels.shape == (2, 2500)


def test_mesh_arguments_are_checked():
    with pytest.raises(ValueError, match="not both"):
        DPMM(DPMMConfig(), device="cpu", mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="axis name"):
        Mesh(["cpu", "cpu"], ("data", "model"))
    with pytest.raises(RuntimeError):
        distributed.make_data_mesh()
    mesh = Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 2}
    assert distributed.n_data_shards(mesh) == 2
    assert distributed.data_axes_of(mesh) == ("data",)
    reps = distributed.replicated(mesh, torch.ones(3))
    assert list(reps) == [torch.device("cpu")]


def test_auto_slab_and_rollback_compose_with_a_mesh():
    """``k_max='auto'`` grows the slab at the same chunk boundaries on 1
    and 2 shards (labels equal, the cross-mesh contract), and an inf row
    on the second shard ends in ``DivergenceError`` with the one-shard
    fit's event log."""
    x, _ = generate_gmm(2000, 2, 8, seed=5)
    cfg = DPMMConfig(k_max="auto", iters=20, burnout=3, log_every=4)
    one = DPMM(cfg, mesh=cpu_mesh(1)).fit(x)
    two = DPMM(cfg, mesh=cpu_mesh(2)).fit(x)
    assert two.slab_sizes == one.slab_sizes and max(one.slab_sizes) > 8
    np.testing.assert_array_equal(one.labels, two.labels)
    bad = x.copy()
    bad[1500] = np.inf
    cfg = DPMMConfig(k_max=8, iters=8, burnout=3, log_every=4,
                     max_recoveries=1)
    logs = []
    for g in (1, 2):
        with pytest.raises(DivergenceError) as got:
            DPMM(cfg, mesh=cpu_mesh(g)).fit(bad)
        logs.append([(e["kind"], e["iter"], e["restored_it"])
                     for e in got.value.recoveries])
    assert logs[0] == logs[1] and len(logs[0]) == 2
