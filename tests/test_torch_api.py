"""The port's entry points, configuration, metrics and package boundary."""
import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.data import synthetic as jax_pkg_synthetic
from repro_torch.configs import DPMMConfig
from repro_torch.core import metrics
from repro_torch.core.family import available_families, get_family
from repro_torch.core.sampler import DPMM, resolve_device
from repro_torch.data import synthetic
from repro_torch.data.synthetic import generate_gmm
from repro_torch.launch import sample_dpmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


ROOT = Path(__file__).resolve().parents[1]


def test_dpmm_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPMM(DPMMConfig())
    with pytest.raises(RuntimeError):
        DPMM(DPMMConfig(), device="cuda")
    assert DPMM(DPMMConfig(), device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


@pytest.mark.parametrize("kw,err", [
    (dict(k_max="auto", tile_size=1024), ValueError),
    (dict(k_max=0), ValueError), (dict(init_clusters=65), ValueError),
    (dict(log_every=0), ValueError), (dict(iters=-1), ValueError),
    (dict(k_block=True), ValueError)])
def test_config_rejects(kw, err):
    with pytest.raises(err):
        DPMMConfig(**kw)


def test_the_four_families_are_registered_and_unknown_names_raise():
    assert available_families() == ("diag_gaussian", "gaussian",
                                     "multinomial", "poisson")
    for name in available_families():
        assert get_family(name).name == name
        assert DPMM(DPMMConfig(component=name), device="cpu").family.name \
            == name
    with pytest.raises(ValueError, match="unknown component family"):
        get_family("student_t")
    with pytest.raises(ValueError, match="registered: diag_gaussian"):
        DPMM(DPMMConfig(component="student_t"), device="cpu")


def test_generate_gmm_is_the_jax_package_copy():
    for got, want in zip(generate_gmm(500, 3, 4, seed=5),
                         jax_pkg_synthetic.generate_gmm(500, 3, 4, seed=5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["generate_mnmm", "generate_pmm"])
def test_count_generators_are_the_jax_package_copies(name):
    for got, want in zip(getattr(synthetic, name)(500, 3, 4, seed=5),
                         getattr(jax_pkg_synthetic, name)(500, 3, 4, seed=5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_nmi_ari_match_the_jax_metrics(seed):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 5, 3000)
    pred = np.where(rng.random(3000) < 0.8, true, rng.integers(0, 9, 3000))
    got = (metrics.nmi(torch.as_tensor(true), torch.as_tensor(pred), 5, 9),
           metrics.ari(torch.as_tensor(true), torch.as_tensor(pred), 5, 9))
    want = (jmetrics.nmi(jnp.asarray(true), jnp.asarray(pred), 5, 9),
            jmetrics.ari(jnp.asarray(true), jnp.asarray(pred), 5, 9))
    np.testing.assert_allclose(got, np.asarray(want, np.float64),
                               rtol=1e-5)
    assert metrics.nmi(torch.as_tensor(true), torch.as_tensor(true),
                       5, 5) == pytest.approx(1.0)


def test_cli_writes_the_result_json(tmp_path, capsys):
    out = tmp_path / "r.json"
    sample_dpmm.main(["--n", "1500", "--d", "2", "--k", "3", "--iters",
                      "20", "--device", "cpu", "--result-path", str(out),
                      "--verbose"])
    res = json.loads(out.read_text())
    assert set(res) == {"labels", "weights", "k", "nmi", "iter_times_s",
                        "device_bytes", "config", "dist", "recoveries"}
    assert len(res["labels"]) == 1500 and len(res["weights"]) == res["k"]
    assert res["config"]["component"] == "gaussian"
    assert res["device_bytes"]["device"] == "cpu"
    assert "iter   20" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown --prior-type"):
        sample_dpmm.main(["--prior-type", "Dirichlet", "--device", "cpu"])


def test_cli_reads_a_data_file(tmp_path):
    x, _ = generate_gmm(1200, 2, 2, seed=3)
    np.save(tmp_path / "x.npy", x)
    out = tmp_path / "r.json"
    sample_dpmm.main(["--data-path", str(tmp_path / "x.npy"), "--iters",
                      "5", "--device", "cpu", "--result-path", str(out)])
    res = json.loads(out.read_text())
    assert len(res["labels"]) == 1200 and np.isnan(res["nmi"])
