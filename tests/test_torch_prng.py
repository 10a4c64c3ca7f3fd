"""The port's counter-based Threefry/Gumbel against the JAX package's.

The words must equal ``repro.kernels.prng`` exactly. The Gumbel values
agree within rtol 1e-6 and atol 2.4e-7: the two libraries evaluate float32
log apart by up to an ulp, and g = -log(L) with L = -log(u) near 1 turns
one ulp of L (1.2e-7) into the same absolute error in g, even where g is
near 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import prng as jprng
from repro_torch.kernels import prng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


M = 0xFFFFFFFF
_KEYS = [(0, 0), (0, 42), (M, M), (0x9E3779B9, 0x7F4A7C15)]


def _counters(case: str):
    rng = np.random.default_rng(7)
    if case == "random":
        return (rng.integers(0, 1 << 32, 512, dtype=np.uint64),
                rng.integers(0, 1 << 32, 512, dtype=np.uint64))
    if case == "near_max":
        c0 = (1 << 32) - 1 - np.arange(256, dtype=np.uint64)
        return c0, np.arange(256, dtype=np.uint64) % 7
    if case == "near_max_slot":
        c0 = np.arange(256, dtype=np.uint64)
        return c0, (1 << 32) - 1 - (np.arange(256, dtype=np.uint64) % 5)
    return np.arange(300, dtype=np.uint64), np.zeros(300, np.uint64)


@pytest.mark.parametrize("key", _KEYS)
@pytest.mark.parametrize("case", ["random", "near_max", "near_max_slot",
                                  "small"])
def test_threefry_words_equal_jax(key, case):
    c0, c1 = _counters(case)
    j0, j1 = jprng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                jnp.asarray(c0.astype(np.uint32)),
                                jnp.asarray(c1.astype(np.uint32)))
    t0, t1 = prng.threefry2x32(torch.tensor(key[0]), torch.tensor(key[1]),
                               torch.as_tensor(c0.astype(np.int64)),
                               torch.as_tensor(c1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0, np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1, np.int64))


@pytest.mark.parametrize("key", _KEYS[1:])
def test_gumbel_matches_jax(key):
    rng = np.random.default_rng(1)
    gidx = rng.integers(0, 1 << 32, 2048, dtype=np.uint64)
    slots = np.arange(16, dtype=np.uint64)
    jg = jprng.gumbel(jnp.asarray(np.array(key, np.uint32)),
                      jnp.asarray(gidx.astype(np.uint32))[:, None],
                      jnp.asarray(slots.astype(np.uint32))[None, :])
    tg = prng.gumbel(torch.tensor(key, dtype=torch.int64),
                     torch.as_tensor(gidx.astype(np.int64))[:, None],
                     torch.as_tensor(slots.astype(np.int64))[None, :])
    assert tg.dtype == torch.float32 and tg.shape == (2048, 16)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=2.4e-7)


def test_uniform01_equals_jax_including_the_top_bin():
    bits = np.array([0, 255, 256, 1 << 31, M - 256, M - 255, M], np.uint64)
    ju = np.asarray(jprng.uniform01(jnp.asarray(bits.astype(np.uint32))))
    tu = prng.uniform01(torch.as_tensor(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(tu, ju)
    assert tu.min() > 0.0
    # (2^24 - 1 + 0.5) * 2^-24 rounds to 1.0 in float32 in both packages,
    # so the top bin (p = 2^-24) gives u == 1 and a +inf Gumbel
    assert tu[-3] < 1.0 and tu[-2] == 1.0 and tu[-1] == 1.0


_SEEDS = (0, 7, (1 << 31) + 5)


def _jax_words(key) -> list:
    return [tuple(int(v) for v in row)
            for row in np.asarray(jax.random.key_data(key)).reshape(-1, 2)]


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("data", [0, 1, 9, -1, -(1 << 31)])
def test_fold_in_is_jax_key_data(seed, data):
    with jax.threefry_partitionable(True):
        key = jax.random.key(seed)
        want = _jax_words(jax.random.fold_in(key, jnp.int32(data)))
    words = _jax_words(key)[0]
    assert prng.fold_in(words, data) == want[0]
    assert prng.fold_in(torch.tensor(words), data) == want[0]


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("n", [3, 6])
def test_split_is_jax_key_data(seed, n):
    with jax.threefry_partitionable(True):
        key = jax.random.key(seed)
        want = _jax_words(jax.random.split(key, n))
    assert prng.split(_jax_words(key)[0], n) == want


def test_key_generators_follow_their_words():
    draw = lambda w: torch.rand(4, generator=prng.generator(w, "cpu"))
    assert torch.equal(draw((1, 2)), draw(torch.tensor([1, 2])))
    assert not torch.equal(draw((1, 2)), draw((2, 1)))
    assert torch.equal(draw((M, M)), torch.rand(
        4, generator=torch.Generator().manual_seed((1 << 64) - 1)))
    t = prng.key_tensor((M, 3), "cpu")
    assert t.dtype == torch.int64 and t.tolist() == [M, 3]
