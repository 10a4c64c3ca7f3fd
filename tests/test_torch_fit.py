"""A whole fit of the port on the CPU against a whole JAX fit.

``generate_gmm(4000, 2, 4, seed=0)``, 30 iterations, default config. The
two chains draw different model-side random numbers, so they are compared
by outcome: the port's K within +-1 of the JAX fit's K and its NMI within
0.05 of the JAX fit's NMI.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs.base import DPMMConfig as JaxConfig
from repro.core.sampler import DPMM as JaxDPMM
from repro_torch.configs import DPMMConfig
from repro_torch.core.sampler import DPMM
from repro_torch.data.synthetic import generate_gmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data():
    return generate_gmm(4000, 2, 4, seed=0)


@pytest.fixture(autouse=True, scope="module")
def jax_fit(data):
    """The JAX fit, started on a thread when the module starts: its
    compile runs while the module's port-only tests do, and
    ``test_fit_matches_the_jax_fit`` (the module's last test) waits for
    it."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: JaxDPMM(JaxConfig(iters=30)).fit(data[0]))


@pytest.fixture(scope="module")
def port_fit(data):
    return DPMM(DPMMConfig(iters=30), device="cpu").fit(data[0])


def test_fit_result_shapes_and_history(data, port_fit):
    x, y = data
    r = port_fit
    assert r.labels.shape == (4000,) and r.labels.dtype == np.int32
    assert r.device == "cpu" and r.peak_bytes is None
    assert len(r.iter_times_s) == 30
    assert set(r.history) == {"k", "max_cluster", "min_cluster", "score"}
    assert all(v.shape == (30,) and np.isfinite(v).all()
               for v in r.history.values())
    assert r.history["k"][-1] == r.k
    # no splits before burnout (15): K stays at init_clusters
    assert (r.history["k"][:15] == 1).all()
    active = r.state.active.numpy()
    assert active[r.labels].all()
    assert r.ari(y) > 0.8 and r.nmi(y) > 0.85


def test_fit_is_reproducible_from_the_seed(data, port_fit):
    again = DPMM(DPMMConfig(iters=30), device="cpu").fit(data[0])
    np.testing.assert_array_equal(again.labels, port_fit.labels)
    np.testing.assert_array_equal(again.history["score"],
                                  port_fit.history["score"])
    other = DPMM(DPMMConfig(iters=30, seed=1), device="cpu").fit(data[0])
    assert not np.array_equal(other.history["score"],
                              port_fit.history["score"])


@pytest.mark.parametrize("compact", [True, False])
def test_fit_accepts_tensors_and_both_slab_modes(data, compact):
    x, y = data
    r = DPMM(DPMMConfig(iters=20, burnout=5, log_every=7, compact=compact),
             device="cpu").fit(torch.as_tensor(x[:2048]))
    assert len(r.iter_times_s) == 20 and r.k >= 2
    assert r.nmi(y[:2048]) > 0.8


def test_fit_matches_the_jax_fit(data, port_fit, jax_fit):
    x, y = data
    ref = jax_fit.result()
    assert abs(port_fit.k - ref.k) <= 1, (port_fit.k, ref.k)
    assert abs(port_fit.nmi(y) - ref.nmi(y)) <= 0.05, (port_fit.nmi(y),
                                                       ref.nmi(y))
