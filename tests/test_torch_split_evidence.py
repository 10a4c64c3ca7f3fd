"""``tools/split_evidence.py`` against the JAX package.

The tool says, with the port's ``splitmerge.log_hastings_split`` in
float64, whether the NIW model keeps two true clusters of
``generate_gmm(n, d, k, seed=0)`` apart (log H_split > 0) or merges them.
The sizes of the port's fits past d = 128 rest on it: at 100,000 x 256
and 16,000 x 160 every pair merges, at 40,000 x 160 none does. Here the reference's ``repro.core.splitmerge.log_hastings_split``
gives the same verdict for every pair on the same true-cluster stats, in
the float32 its sampler runs in; the values agree within rtol 2e-3, atol 2
(float32 log marginals of ~10^7 that cancel down to ~10^3).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs import DPMMConfig as JDPMMConfig
from repro.core import niw as jniw
from repro.core import splitmerge as jsplitmerge
from repro.core.family import get_family as jget_family
from repro_torch.data.synthetic import generate_gmm

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "split_evidence.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes, and
    float64 ``slogdet`` can hang in MKL once another module has changed
    the thread count. numpy's BLAS too (the float64 Gram matrices of
    both sides): a thread a core in each test process oversubscribes the
    machine."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def _tool():
    spec = importlib.util.spec_from_file_location("split_evidence", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_pair_evidence(x, y, k):
    """{(a, b): log H_split} of every pair a < b, through the reference."""
    fam, cfg = jget_family("gaussian"), JDPMMConfig()
    prior = fam.build_prior(cfg, x)
    stats = []
    for j in range(k):
        xs = x[y == j].astype(np.float64)
        stats.append((float(xs.shape[0]), xs.sum(0), xs.T @ xs))
    a_idx, b_idx = np.triu_indices(k, 1)
    f32 = lambda rows: jnp.asarray(np.stack(rows), jnp.float32)
    sub = jniw.GaussStats(*(
        f32([np.stack([stats[a][i], stats[b][i]])
             for a, b in zip(a_idx, b_idx)]) for i in range(3)))
    full = jniw.GaussStats(*(
        f32([stats[a][i] + stats[b][i] for a, b in zip(a_idx, b_idx)])
        for i in range(3)))
    log_h = np.asarray(jax.jit(
        lambda p, f, s: jsplitmerge.log_hastings_split(p, fam, f, s,
                                                       cfg.alpha))(
        prior, full, sub))
    return {(int(a), int(b)): float(h)
            for a, b, h in zip(a_idx, b_idx, log_h)}


@pytest.mark.parametrize("n,d,k,merged", [
    (16_000, 160, 4, 6), (40_000, 160, 4, 0), (100_000, 256, 16, 120)])
def test_split_evidence_matches_the_reference(n, d, k, merged):
    x, y = generate_gmm(n, d, k, seed=0)
    port = _tool().pair_evidence(x, y, k)
    ref = _jax_pair_evidence(x, y, k)
    assert len(port) == len(ref) == k * (k - 1) // 2
    assert sum(h < 0 for h, _, _ in port) == merged
    for h, a, b in port:
        assert (ref[(a, b)] < 0) == (h < 0), (a, b, h, ref[(a, b)])
        np.testing.assert_allclose(ref[(a, b)], h, rtol=2e-3, atol=2.0)
