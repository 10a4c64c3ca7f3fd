"""Feature sharding of the port (``DPMMConfig.shard_features`` on a mesh
with a ``model`` axis) on the CPU, with logical shards.

- ``ComponentFamily.loglik_sharded`` and ``splitmerge.hyperplane_bits``
  on a (2 x 2) mesh against the reference's under ``shard_map`` over the
  4 virtual CPU devices of ``tests/conftest.py``: within 1e-5 relative,
  and equal;
- for multinomial, poisson and diag_gaussian the (2 x 2) fit (features
  split in two, the plain route) gives the (2 x 1) fit's labels
  (``tests/test_distributed_dpmm.py``'s feature-sharded tests);
- the tiled feature-sharded chain is the resident one bit for bit
  (``tests/test_tiled_parity.py``'s);
- a Gaussian keeps its features whole under ``shard_features``, and
  ``workers`` with ``shard_features`` is refused.

No JAX fit runs here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from repro.core import distributed as jdist
from repro.core import multinomial as jmult
from repro.core import splitmerge as jsm
from repro.core.family import get_family as jget_family
from repro_torch.configs import DPMMConfig
from repro_torch.core import distributed, splitmerge
from repro_torch.core.distributed import FeatureShards, Mesh
from repro_torch.core.family import get_family, shardable_families
from repro_torch.core.multinomial import MultParams
from repro_torch.core.sampler import DPMM
from repro_torch.data.source import HostTiledSource
from repro_torch.data.synthetic import generate_gmm, generate_mnmm, \
    generate_pmm

FIT = dict(alpha=10.0, k_max=16, iters=20, burnout=5, log_every=10)
DATA = {"multinomial": lambda: generate_mnmm(1024, 32, 5, seed=1),
        "poisson": lambda: generate_pmm(1023, 16, 4, seed=2),   # padded
        "diag_gaussian": lambda: generate_gmm(1024, 16, 4, seed=3, sep=8.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def mesh(g: int, m: int) -> Mesh:
    if m == 1:
        return Mesh(["cpu"] * g, ("data",))
    return Mesh(np.array(["cpu"] * (g * m)).reshape(g, m),
                ("data", "model"))


def _jmesh22():
    assert jax.device_count() == 4, "tests/conftest.py sets 4 devices"
    return JMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                 ("data", "model"))


def _port_shards(x):
    """x on the port's (2 x 2) mesh: each data shard's FeatureShards."""
    xs, _ = distributed.shard_points(mesh(2, 2), x, shard_features=True)
    assert all(isinstance(s, FeatureShards) and len(s.slices) == 2
               for s in xs)
    return xs


def test_loglik_sharded_and_hyperplane_bits_are_the_references():
    rng = np.random.default_rng(0)
    n, d, k = 512, 32, 6
    x = rng.poisson(3.0, (n, d)).astype(np.float32)
    logtheta = np.log(rng.dirichlet(np.ones(d), k)).astype(np.float32)
    jm = _jmesh22()
    ref = jax.jit(jdist.shard_map(
        lambda xl, lt: jget_family("multinomial").loglik_sharded(
            xl, jmult.MultParams(logtheta=lt), "model"),
        mesh=jm, in_specs=(P("data", "model"), P()),
        out_specs=P("data")))(jnp.asarray(x), jnp.asarray(logtheta))
    fam = get_family("multinomial")
    port = torch.cat([fam.loglik_sharded(
        s, MultParams(logtheta=torch.from_numpy(logtheta)))
        for s in _port_shards(x)])
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())
    # the hyperplane sub-labels: the projection summed over the slices
    xg = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    means = rng.standard_normal((k, d)).astype(np.float32)
    v = rng.standard_normal((k, d)).astype(np.float32)
    ref = jax.jit(jdist.shard_map(
        lambda xl, lab, mu, vv: jsm.hyperplane_bits(xl, lab, mu, vv,
                                                    "model"),
        mesh=jm, in_specs=(P("data", "model"), P("data"), P(), P()),
        out_specs=P("data")))(jnp.asarray(xg), jnp.asarray(labels),
                              jnp.asarray(means), jnp.asarray(v))
    lab_t = torch.from_numpy(labels)
    port = torch.cat([splitmerge.hyperplane_bits(
        s, lab_t[i * n // 2:(i + 1) * n // 2], torch.from_numpy(means),
        torch.from_numpy(v)) for i, s in enumerate(_port_shards(xg))])
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    unsharded = splitmerge.hyperplane_bits(
        torch.from_numpy(xg), lab_t, torch.from_numpy(means),
        torch.from_numpy(v))
    assert int((unsharded != port).sum()) == 0


@pytest.mark.parametrize("component", sorted(DATA))
def test_feature_sharded_fit_gives_the_unsharded_labels(component):
    assert component in shardable_families()
    x, y = DATA[component]()
    plain = DPMM(DPMMConfig(component=component, **FIT),
                 mesh=mesh(2, 1)).fit(x)
    sharded = DPMM(DPMMConfig(component=component, shard_features=True,
                              **FIT), mesh=mesh(2, 2)).fit(x)
    assert sharded.mesh["model_shards"] == 2
    assert plain.k == sharded.k
    np.testing.assert_array_equal(plain.labels, sharded.labels)
    np.testing.assert_array_equal(plain.history["k"], sharded.history["k"])
    assert sharded.nmi(y) > 0.9
    # a reduction gathers every slice's feature fields once, n once
    t = get_family(component).slot_floats(x.shape[1])
    per = sharded.mesh["reduce_bytes"] / sharded.mesh["reductions"]
    assert per <= 2 * FIT["k_max"] * 2 * t * 4


def test_tiled_feature_sharded_is_the_resident_chain():
    x, _ = generate_mnmm(2000, 32, 5, seed=1)
    cfg = dict(FIT, component="multinomial", shard_features=True)
    resident = DPMM(DPMMConfig(**cfg), mesh=mesh(2, 2)).fit(x)
    tiled = DPMM(DPMMConfig(tile_size=512, **cfg),
                 mesh=mesh(2, 2)).fit(HostTiledSource(x))
    np.testing.assert_array_equal(resident.labels, tiled.labels)
    for key in resident.history:
        np.testing.assert_array_equal(resident.history[key],
                                      tiled.history[key])
    for name in ("n", "counts"):
        assert torch.equal(getattr(resident.state.substats, name),
                           getattr(tiled.state.substats, name))
    assert tiled.mesh["model_shards"] == 2


def test_gaussian_keeps_its_features_and_workers_refuse():
    x, _ = generate_gmm(512, 4, 3, seed=4, sep=10.0)
    cfg = DPMMConfig(alpha=10.0, iters=10, k_max=8, burnout=3,
                     shard_features=True)
    model = DPMM(cfg, mesh=mesh(2, 2))
    assert not model.feature_sharded
    r = model.fit(x)
    assert r.k >= 1 and r.mesh["model_shards"] == 1
    assert r.mesh["data_shards"] == 2
    with pytest.raises(ValueError, match="shard_features"):
        DPMMConfig(workers=2, shard_features=True)
    with pytest.raises(ValueError, match="feature-separable"):
        get_family("gaussian").loglik_sharded(None, None)
    with pytest.raises(ValueError, match="does not split"):
        distributed.shard_points(mesh(1, 2), np.zeros((4, 3), np.float32),
                                 shard_features=True)
