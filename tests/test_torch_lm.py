"""The port's LM zoo (``repro_torch.models``, ``serve.engine``) against the
JAX package's, on the CPU at ``smoke_config`` sizes.

For each dense-attention arch (granite-8b, starcoder2-7b, gemma2-9b,
mistral-large-123b) one module fixture draws a parameter tree of the
reference's structure with numpy (the shapes of
``repro.models.transformer.init_params``), runs the reference's ``forward``,
``hidden_forward``, ten teacher-forced ``decode_step`` calls and its
greedy ``Generator``, and carries the parameters into the port with
``params_from_jax``. Bounds: the port's float32 logits and hidden states
are the reference's to a relative max error (``max|diff| / max|ref|``, as
``tests/test_zoo.py``) of 1e-5; measured: 7e-7 to 1.4e-6 for the four
archs.
Greedy token ids are equal. The port's decode against its own forward and
the sliding-window ring take the reference's own bound (1e-4). The
configs of all ten archs equal the reference's field for field; the six
archs outside this slice raise ``NotImplementedError`` naming ROADMAP.md.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.launch.mesh import make_host_mesh
from repro.models import decode as jdecode
from repro.models import transformer as jtransformer
from repro.models.common import ShardingPolicy
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import common, decode, transformer
from repro_torch.serve import engine

DENSE = ("granite-8b", "starcoder2-7b", "gemma2-9b", "mistral-large-123b")
OTHERS = tuple(a for a in configs.ARCH_IDS if a not in DENSE)
POLICY = ShardingPolicy(batch_sharded=False, seq_shard=False)
B, S, DEC = 2, 16, 10            # forward batch and length, decode steps
PROMPT, STEPS = 8, 16            # the Generator's request
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _shape():
    return dataclasses.replace(jconfigs.INPUT_SHAPES["decode_32k"],
                               seq_len=64, global_batch=B)


def _port_shape():
    return dataclasses.replace(configs.INPUT_SHAPES["decode_32k"],
                               seq_len=64, global_batch=B)


def _numpy_params(jcfg, seed=0):
    """A parameter tree of the reference's structure and shapes
    (``jax.eval_shape`` of its ``init_params``), drawn with numpy: the
    token table at the reference's scale (0.02), every other matrix at
    1/sqrt(d_model), the norm scales at 0.1 (so ``1 + scale`` is not 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: jtransformer.init_params(k, jcfg), jax.random.key(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['tok']"):
            std = 0.02
        elif name.endswith("['scale']"):
            std = 0.1
        else:
            std = jcfg.d_model ** -0.5
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _reference(arch):
    """The reference's parameters (numpy), tokens, logits, hidden states,
    decode logits and greedy tokens for one arch."""
    jcfg = jconfigs.smoke_config(arch)
    params = _numpy_params(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S),
                                             dtype=np.int32)

    @jax.jit
    def full(p, t):
        logits, _ = jtransformer.forward(p, t, jcfg, POLICY, remat=False)
        hidden, _ = jtransformer.hidden_forward(p, t, jcfg, POLICY,
                                                remat=False)
        return logits, hidden

    logits, hidden = full(params, toks)
    step = jax.jit(lambda p, c, t: jdecode.decode_step(
        p, c, t, jcfg, POLICY, cache_len=DEC))
    c = jdecode.init_cache(jcfg, B, DEC, jnp.float32)
    dec = []
    for t in range(DEC):
        lg, c = step(params, c, toks[:, t:t + 1])
        dec.append(np.asarray(lg[:, 0]))
    gen = jengine.Generator(make_host_mesh(1, 1), jcfg, _shape(), params)
    greedy = gen.generate(toks[:, :PROMPT], steps=STEPS)
    return dict(
        tree=params, tokens=toks,
        logits=np.asarray(logits), hidden=np.asarray(hidden),
        decode=np.stack(dec, axis=1), greedy=np.asarray(greedy))


@pytest.fixture(autouse=True, scope="module")
def _references():
    """The four archs' reference outputs, computed on two threads from the
    module's start: the JAX compiles (which release the GIL) run two at a
    time, and while the port-only tests do."""
    with ThreadPoolExecutor(2) as pool:
        yield {arch: pool.submit(_reference, arch) for arch in DENSE}


@pytest.fixture(scope="module")
def ref(_references):
    """arch -> its reference outputs (``_reference``), waited for."""
    return lambda arch: _references[arch].result()


def _port(arch, r):
    return transformer.params_from_jax(configs.smoke_config(arch), r["tree"],
                                       device="cpu")


def _decode(model, tokens, cache_len, batch=B):
    cache = decode.init_cache(model.cfg, batch, cache_len, torch.float32,
                              device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = decode.decode_step(model, cache, tokens[:, t:t + 1],
                                       cache_len=cache_len)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# configs (pure Python)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_the_references(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for get in ("get_config", "smoke_config"):
        port, want = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(want), get
        assert port.layer_kinds == want.layer_kinds
        assert port.pattern_repeats == want.pattern_repeats
        assert port.resolved_head_dim == want.resolved_head_dim
    cfg = configs.get_config(arch)
    fk = configs.first_k_dense(arch)
    assert fk == jconfigs.first_k_dense(jconfigs.get_config(arch))
    assert transformer.layout(cfg, fk) == transformer.Layout(
        *dataclasses.astuple(jtransformer.layout(jconfigs.get_config(arch))))


def test_input_shapes_and_window_override_are_the_references():
    assert ({k: dataclasses.asdict(v) for k, v in configs.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jconfigs.INPUT_SHAPES.items()})
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for shape in configs.INPUT_SHAPES.values():
            want = (shape.seq_len > 32_768
                    and cfg.long_context == "sliding_window")
            assert engine.uses_window_override(cfg, shape) == want
            for kind in (configs.ATTN, configs.LOCAL_ATTN):
                for wo in (False, True):
                    args = (kind, cfg, shape.seq_len, wo)
                    assert (decode._attn_cache_len(*args)
                            == jdecode._attn_cache_len(
                                kind, jconfigs.get_config(arch),
                                shape.seq_len, wo))
                    assert decode._is_local(*args) == jdecode._is_local(
                        kind, jconfigs.get_config(arch), shape.seq_len, wo)


@pytest.mark.parametrize("arch", OTHERS)
def test_archs_outside_the_slice_raise(arch):
    cfg = configs.smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        transformer.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        decode.init_cache(cfg, 1, 8, torch.float32, device="cpu")


def test_generator_without_a_card_raises(monkeypatch):
    """Every entry point defaults to the card and raises without one."""
    cfg = configs.smoke_config("granite-8b")
    model = transformer.init_params(0, cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.Generator(cfg, _port_shape(), model)
    tree = {k: {n: p.detach().numpy() for n, p in v.named_parameters()}
            for k, v in (("embed", model.embed),
                         ("final_norm", model.final_norm))}
    for build in (lambda: transformer.init_params(0, cfg),
                  lambda: transformer.Transformer(cfg),
                  lambda: transformer.params_from_jax(cfg, tree),
                  lambda: decode.init_cache(cfg, 1, 8, torch.float32)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_token_pipeline_is_the_references():
    for vocab, seed in ((512, 0), (85, 3003)):
        a = TokenPipeline(vocab, seed=seed)
        b = jpipeline.TokenPipeline(vocab, seed=seed)
        for n in (64, 130):
            np.testing.assert_array_equal(a.sample(n), b.sample(n))


def test_norm_rope_and_activations_are_the_references():
    from repro.models import common as jcommon
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 4
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.array([0, 1, 7, 4095, 524_287])
    assert rel(common.rmsnorm(torch.tensor(x), torch.tensor(scale), 1e-6),
               jcommon.rmsnorm(jnp.asarray(x), {"scale": scale}, 1e-6)) < RTOL
    assert rel(common.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
               ) < RTOL
    for act in ("silu", "gelu"):
        assert rel(common.activation(act)(torch.tensor(x)),
                   jcommon.activation(act)(jnp.asarray(x))) < RTOL
    assert rel(common.softcap(torch.tensor(x) * 20, 30.0),
               jcommon.softcap(jnp.asarray(x) * 20, 30.0)) < RTOL


def test_params_from_jax_checks_every_leaf(ref):
    cfg = configs.smoke_config("granite-8b")
    tree = ref("granite-8b")["tree"]
    model = transformer.params_from_jax(cfg, tree, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    missing = jax.tree.map(lambda a: a, tree)
    del missing["blocks"]["0_attn"]["attn"]["wk"]
    with pytest.raises(ValueError, match="missing leaf blocks/0_attn/attn/wk"):
        transformer.params_from_jax(cfg, missing, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["embed"]["head2"] = extra["embed"]["tok"]
    with pytest.raises(ValueError, match="extra leaf embed/head2"):
        transformer.params_from_jax(cfg, extra, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["0_attn"]["mlp"]["up"] = bad["blocks"]["0_attn"]["mlp"][
        "up"][:, :, :-1]
    with pytest.raises(ValueError, match="mlp/up: shape"):
        transformer.params_from_jax(cfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# parity with the reference, per dense arch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_decode_match_the_reference(ref, arch):
    """forward logits, hidden_forward states and ten teacher-forced decode
    steps against the reference's; measured max relative error about 1e-6
    (bound 1e-5)."""
    r = ref(arch)
    model = _port(arch, r)
    toks = torch.tensor(r["tokens"]).long()
    logits, aux = transformer.forward(model, toks)
    hidden, _ = transformer.hidden_forward(model, toks)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert rel(logits, r["logits"]) < RTOL
    assert rel(hidden, r["hidden"]) < RTOL
    assert rel(_decode(model, toks[:, :DEC], DEC), r["decode"]) < RTOL


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_the_ports_forward(ref, arch):
    """The counterpart of test_zoo.py's decode-vs-forward check, on the
    port alone."""
    r = ref(arch)
    model = _port(arch, r)
    toks = torch.tensor(r["tokens"][:, :DEC]).long()
    full, _ = transformer.forward(model, toks)
    assert rel(_decode(model, toks, DEC), full) < 1e-4


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generator_gives_the_references_tokens(ref, arch):
    r = ref(arch)
    gen = engine.Generator(configs.smoke_config(arch), _port_shape(),
                           r["tree"], device="cpu")
    out = gen.generate(r["tokens"][:, :PROMPT], steps=STEPS)
    assert out.shape == (B, PROMPT + STEPS)
    np.testing.assert_array_equal(out.numpy(), r["greedy"])


def test_sampling_repeats_with_its_seed_and_stays_in_range():
    cfg = configs.smoke_config("gemma2-9b")
    model = transformer.init_params(3, cfg, device="cpu")
    gen = engine.Generator(cfg, _port_shape(), model, temperature=0.8,
                           device="cpu")
    prompts = np.arange(B * PROMPT).reshape(B, PROMPT) % cfg.vocab_size
    a = gen.generate(prompts, steps=STEPS, seed=5)
    b = gen.generate(prompts, steps=STEPS, seed=5)
    c = gen.generate(prompts, steps=STEPS, seed=6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    np.testing.assert_array_equal(a[:, :PROMPT].numpy(), prompts)


def test_sliding_window_ring_decode():
    """Decode past the window with a ring cache == the full forward, whose
    blockwise attention masks the window (the counterpart of
    test_zoo.py::test_sliding_window_ring_decode: window 8, 20 steps)."""
    cfg = dataclasses.replace(configs.smoke_config("gemma2-9b"),
                              sliding_window=8)
    s = 20
    model = transformer.init_params(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, s),
                         generator=torch.Generator().manual_seed(1))
    full, _ = transformer.forward(model, toks)
    cache = decode.init_cache(cfg, 1, s, torch.float32, device="cpu")
    assert [c["kv"]["k"].shape[1] for c in cache["layers"]] == [8, s]
    assert rel(_decode(model, toks, s, batch=1), full) < 1e-4
