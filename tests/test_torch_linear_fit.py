"""Whole fits of the linear families on the CPU.

- multinomial: ``generate_mnmm(3000, 16, 4, seed=0)``, 30 iterations,
  burnout 10, against one JAX fit of the same data and config
  (``use_pallas`` off). The chains draw different model-side random
  numbers, so they are compared by outcome: K within +-1 and NMI within
  0.05 of the JAX fit's.
- poisson and diag_gaussian: port-only fits against the generator's
  labels (NMI >= 0.9), each launched through the family's sweep and
  label-stat fold.
- the CLI with ``--prior-type Multinomial --device cpu``.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs.base import DPMMConfig as JaxConfig
from repro.core.sampler import DPMM as JaxDPMM
from repro_torch.configs import DPMMConfig
from repro_torch.core.sampler import DPMM
from repro_torch.data.synthetic import (generate_gmm, generate_mnmm,
                                        generate_pmm)
from repro_torch.launch import sample_dpmm

CFG = dict(iters=30, burnout=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def jax_fit():
    """The JAX multinomial fit, started on a thread when the module
    starts: its compile runs while the module's port-only tests do, and
    ``test_multinomial_fit_matches_the_jax_fit`` (the module's last test)
    waits for it."""
    x, _ = generate_mnmm(3000, 16, 4, seed=0)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: JaxDPMM(JaxConfig(
            component="multinomial", **CFG)).fit(x))


@pytest.mark.parametrize("component,data", [
    ("poisson", lambda: generate_pmm(3000, 8, 4, seed=1)),
    ("diag_gaussian", lambda: generate_gmm(3000, 3, 4, seed=2))])
def test_linear_family_fit_finds_the_clusters(component, data):
    x, y = data()
    r = DPMM(DPMMConfig(component=component, **CFG), device="cpu").fit(x)
    assert r.nmi(y) >= 0.9, (component, r.k, r.nmi(y))
    assert r.history["k"][-1] == r.k and len(r.iter_times_s) == 30
    assert type(r.state.stats).__module__.endswith(component)


def test_cli_fits_the_multinomial_family(tmp_path):
    out = tmp_path / "r.json"
    sample_dpmm.main(["--prior-type", "Multinomial", "--n", "2000", "--d",
                      "16", "--k", "3", "--iters", "25", "--device", "cpu",
                      "--result-path", str(out)])
    res = json.loads(out.read_text())
    assert res["config"]["component"] == "multinomial"
    assert len(res["labels"]) == 2000 and res["nmi"] >= 0.9


def test_multinomial_fit_matches_the_jax_fit(jax_fit):
    x, y = generate_mnmm(3000, 16, 4, seed=0)
    port = DPMM(DPMMConfig(component="multinomial", **CFG),
                device="cpu").fit(x)
    ref = jax_fit.result()
    assert abs(port.k - ref.k) <= 1, (port.k, ref.k)
    assert abs(port.nmi(y) - ref.nmi(y)) <= 0.05, (port.nmi(y), ref.nmi(y))
    assert port.state.active.numpy()[port.labels].all()
