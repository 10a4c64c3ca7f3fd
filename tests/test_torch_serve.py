"""The port's serving engine against the JAX package's, on one checkpoint.

For each family a small model is fitted by the port on the CPU and written
with the port's ``save_model``; the JAX package's ``DPMMEngine`` (its
default ``use_pallas=False``) and the port's (``device="cpu"``) load the
same file and answer the same queries, both with
``ServeConfig(batch_sizes=(64, 256))``. Rules: labels and sampled labels
(the JAX key words injected) equal except counted near-ties (the two
logits within 1e-4); log p(k | x) on active slots and log p(x) within
rtol 1e-5, atol 1e-4, inactive slots exactly -1e30; ``to_json()`` equal
field for field.
"""
import json

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.kernels import prng as jprng
from repro.serve import dpmm as jserve
from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint
from repro_torch.core.sampler import DPMM
from repro_torch.data import synthetic
from repro_torch.launch import serve_dpmm
from repro_torch.serve import dpmm as tserve

LADDER = (64, 256)
TIE_RTOL = 1e-4
FITS = {"gaussian": ("generate_gmm", 4), "diag_gaussian": ("generate_gmm", 4),
        "multinomial": ("generate_mnmm", 8), "poisson": ("generate_pmm", 8)}


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
def served(tmp_path_factory):
    """family -> (checkpoint path, queries, fit result)."""
    out = {}
    root = tmp_path_factory.mktemp("serve")
    for family, (gen, d) in FITS.items():
        make = getattr(synthetic, gen)
        x, _ = make(1500, d, 4, seed=0)
        res = DPMM(DPMMConfig(component=family, k_max=16, iters=20,
                              burnout=5), device="cpu").fit(x)
        path = checkpoint.save_model(str(root / family), res.state, family)
        q, _ = make(333, d, 4, seed=1)
        out[family] = (path, np.asarray(q, np.float32), res)
    return out


def _engines(path):
    cfg_j = jserve.ServeConfig(batch_sizes=LADDER)
    cfg_t = tserve.ServeConfig(batch_sizes=LADDER)
    return (jserve.DPMMEngine.from_checkpoint(path, cfg_j),
            tserve.DPMMEngine.from_checkpoint(path, cfg_t, device="cpu"))


def _label_ties(lab_a, lab_b, logits) -> int:
    """Mismatched rows; raises unless each is a near-tie of ``logits``
    ((N, K_max), the two labels' values)."""
    bad = np.flatnonzero(lab_a != lab_b)
    for i in bad:
        a, b = logits[i, lab_a[i]], logits[i, lab_b[i]]
        assert abs(a - b) <= TIE_RTOL * max(1.0, abs(a), abs(b)), (i, a, b)
    assert bad.size <= 0.01 * lab_a.size
    return int(bad.size)


@pytest.mark.parametrize("family", list(FITS))
def test_port_engine_answers_as_the_jax_engine(served, family):
    path, q, _ = served[family]
    je, te = _engines(path)
    assert (te.k_max, te.d, te.k_active) == (je.k_max, je.d, je.k_active)
    np.testing.assert_array_equal(te.slots, np.asarray(je.slots))
    a, b = je.query(q), te.query(q)
    act = np.zeros(je.k_max, bool)
    act[np.asarray(je.slots)[:je.k_active]] = True
    np.testing.assert_allclose(b.logprobs[:, act], a.logprobs[:, act],
                               rtol=1e-5, atol=1e-4)
    assert (b.logprobs[:, ~act] == np.float32(-1e30)).all()
    np.testing.assert_allclose(b.log_predictive, a.log_predictive,
                               rtol=1e-5, atol=1e-4)
    _label_ties(b.labels, a.labels, a.logprobs)
    # a posterior draw with the JAX engine's key words injected
    words = np.asarray(jprng.key_words(jax.random.key(11)))
    sa = je.sample(q, seed=11)
    sb = te.sample(q, key_words=words)
    gumbel = np.asarray(jprng.gumbel(words, np.arange(q.shape[0],
                                                      dtype=np.uint32)[:, None],
                                     np.arange(je.k_max,
                                               dtype=np.uint32)[None, :]))
    _label_ties(sb, sa, a.logprobs + gumbel)


@pytest.mark.parametrize("family", ["gaussian", "multinomial"])
def test_to_json_equals_the_jax_engine_field_for_field(served, family):
    path, q, _ = served[family]
    je, te = _engines(path)
    words = np.asarray(jprng.key_words(jax.random.key(2)))
    a = je.query(q, sample=True, seed=2).to_json(include_logprobs=True)
    b = te.query(q, sample=True, key_words=words).to_json(
        include_logprobs=True)
    assert list(b) == list(a)
    for k in ("n", "family", "k_max", "model_epoch"):
        assert b[k] == a[k], k
    assert b["labels"] == a["labels"]
    assert b["sampled_labels"] == a["sampled_labels"]
    assert b["cluster_counts"] == a["cluster_counts"]
    np.testing.assert_allclose(b["log_predictive"], a["log_predictive"],
                               rtol=1e-5, atol=1e-4)
    json.dumps(b)


@pytest.mark.parametrize("family", ["gaussian", "diag_gaussian"])
def test_ragged_dispatch_is_bitwise_invisible(served, family):
    path, q, _ = served[family]
    te = tserve.DPMMEngine.from_checkpoint(
        path, tserve.ServeConfig(batch_sizes=LADDER), device="cpu")
    assert te.plan_route(333) == [(0, 256, 256), (256, 77, 256)]
    assert te.plan_route(50) == [(0, 50, 64)]
    whole = te.query(q, sample=True, seed=4)
    start = 0
    for n in (1, 63, 64, 65, 140):
        part = te.query(q[start:start + n])
        for f in ("labels", "logprobs", "log_predictive"):
            np.testing.assert_array_equal(getattr(part, f),
                                          getattr(whole, f)[start:start + n])
        start += n
    # draws are counted on the row index: a request of the same rows
    # from row 0 draws the same labels
    np.testing.assert_array_equal(te.sample(q[:100], seed=4),
                                  whole.sampled_labels[:100])
    assert te.query(q[:0]).labels.shape == (0,)


def test_invalid_queries_raise(served):
    path, q, _ = served["gaussian"]
    te = tserve.DPMMEngine.from_checkpoint(
        path, tserve.ServeConfig(batch_sizes=LADDER), device="cpu")
    bad = q.copy()
    bad[7, 1] = np.nan
    with pytest.raises(tserve.InvalidQueryError, match="non-finite"):
        te.query(bad)
    with pytest.raises(tserve.InvalidQueryError, match=r"\(N, 4\)"):
        te.predict(q[:, :3])
    with pytest.raises(ValueError, match="ascending"):
        tserve.ServeConfig(batch_sizes=(64, 64))
    # refinement is ported: its knobs are checked as the reference's
    assert tserve.ServeConfig(refine=True).refine
    with pytest.raises(ValueError, match="at least one refine_batch"):
        tserve.ServeConfig(refine=True, refine_batch=512, refine_buffer=256)
    with pytest.raises(ValueError, match="refine_decay"):
        tserve.ServeConfig(refine=True, refine_decay=1.0)


def test_swap_gates_on_model_health_and_flips_atomically(served, tmp_path):
    path, q, res = served["gaussian"]
    te = tserve.DPMMEngine.from_checkpoint(
        path, tserve.ServeConfig(batch_sizes=LADDER), device="cpu")
    before = te.query(q)
    sick = res.state.replace(stats=res.state.stats.__class__(
        n=res.state.stats.n.clone().fill_(float("nan")),
        sx=res.state.stats.sx, sxx=res.state.stats.sxx))
    bad_path = checkpoint.save_model(str(tmp_path / "sick"), sick,
                                     "gaussian")
    with pytest.raises(tserve.PublishRejected):
        te.swap(bad_path)
    assert te.epoch == 0 and te.events[-1]["kind"] == "model_swap_rejected"
    np.testing.assert_array_equal(te.query(q).log_predictive,
                                  before.log_predictive)
    other = checkpoint.save_model(str(tmp_path / "other"), served[
        "diag_gaussian"][2].state, "diag_gaussian")
    assert te.swap(other) == 1 and te.family.name == "diag_gaussian"
    after = te.query(q)
    assert after.model_epoch == 1 and after.family == "diag_gaussian"
    assert not np.array_equal(after.log_predictive, before.log_predictive)


def test_cli_writes_the_result_json_on_the_cpu(served, tmp_path):
    path, q, _ = served["poisson"]
    np.save(tmp_path / "q.npy", q)
    out = tmp_path / "r.json"
    serve_dpmm.main(["--checkpoint", path, "--queries",
                     str(tmp_path / "q.npy"), "--batch-sizes", "64,256",
                     "--sample", "--seed", "3", "--result-path", str(out),
                     "--device", "cpu"])
    got = json.loads(out.read_text())
    te = tserve.DPMMEngine.from_checkpoint(
        path, tserve.ServeConfig(batch_sizes=LADDER, seed=3), device="cpu")
    assert got == json.loads(json.dumps(
        te.query(q, sample=True, seed=3).to_json()))
