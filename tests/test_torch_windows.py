"""Stat windows, slot windows, the routes past d = 256 and the one-launch
fold, on the CPU.

- ``labelstats.window_rows``: STATS_BLOCK-aligned point windows whose
  partials fit ``WINDOW_BYTES`` (or are one block), covering N; the main
  fits' shapes are one window;
- ``suffstats.slot_windows``: every slot in one window of at most MAX_K;
- the dense oracle's panel tile and ``sub_assign_gauss``'s column panels
  past d = 256 (``dense_plan``, ``sub_col``): every entry or column owned
  once, each lane's |y|^2 chain over its columns in order;
- with the budget patched down to one block, ``stats_from_labels`` and the
  one-read ``sweep`` give their unwindowed results bit for bit (every
  stat element is still the accumulator plus the blocks in order);
- ``ComponentFamily.sweep`` declines a slab past the one-read kernels'
  2048 slots to ``sweep_ref``, from the shape alone;
- at d = 260 the port's label fold and step (f) against the JAX
  package's (``stats_from_labels``, ``sub_assign``, its jnp route);
- the fold's plain path (``fold_fields_plain``, ``fold_stats``) is the
  per-field loop of adds, and ``fold.row_layout`` addresses every element
  of a strided field;
- the merge proposals, scored over the live pairs only, give the decision
  of scoring every pair.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import niw as jniw
from repro.core.family import get_family as jget_family
from repro_torch.configs import DPMMConfig
from repro_torch.core import labelstats
from repro_torch.core.family import GAUSSIAN, get_family
from repro_torch.core.niw import GaussParams, GaussStats
from repro_torch.core.state import tree_map, tree_map2
from repro_torch.data.synthetic import generate_gmm, generate_mnmm
from repro_torch.kernels import assign, fold
from repro_torch.kernels.assign import sub_col
from repro_torch.kernels.suffstats import (MAX_K, SMEM_LIMIT, STATS_BLOCK,
                                           dense_plan, slot_windows)
from repro_torch.kernels.sweep import MAX_K as SWEEP_MAX_K

TIE_RTOL = 1e-4


@pytest.mark.parametrize("n,k,floats", [
    (1, 1, 1), (0, 4, 4), (1023, 5, 3), (5 * 1024, 64, 1057),
    (1_000_000, 64, 1 + 32 + 32 * 32), (400_000, 32, 1 + 256 + 256 * 256),
    (400_000, 32, 1 + 384 + 384 * 384), (4097, 8192, 1 + 384 + 384 * 384),
    (1_000_003, 4096, 1 + 8 + 64)])
def test_window_rows_are_aligned_windows_within_the_budget(n, k, floats):
    wins = labelstats.window_rows(n, k, floats)
    assert wins[0][0] == 0 and wins[-1][1] == n
    for (a, b), (c, _) in zip(wins, wins[1:]):
        assert b == c
    per_block = 4 * 2 * k * floats
    for a, b in wins:
        assert a % STATS_BLOCK == 0
        assert b == n or b % STATS_BLOCK == 0
        blocks = -(-(b - a) // STATS_BLOCK)
        assert (blocks * per_block <= labelstats.WINDOW_BYTES
                or b - a <= STATS_BLOCK)
    # as many whole blocks a window as the budget holds: no two windows
    # would fit together
    if len(wins) > 1:
        assert 2 * -(-(wins[0][1]) // STATS_BLOCK) * per_block \
            > labelstats.WINDOW_BYTES


@pytest.mark.parametrize("family,n,d,k,windows", [
    ("gaussian", 1_000_000, 32, 64, 1),          # the 10^6 x 32 fit
    ("multinomial", 1_000_000, 128, 64, 1),      # the multinomial fit
    # the d = 128 fit: its sweep over the 32-slot slab, its split/merge
    # fold over 64 slots
    ("gaussian", 200_000, 128, 32, 1),
    ("gaussian", 200_000, 128, 64, 2),
    ("diag_gaussian", 200_000, 32, 64, 1),
    ("poisson", 200_000, 32, 64, 1),
    # the d = 256 fit: its sweep's 32 slots, its split/merge fold's 64
    ("gaussian", 400_000, 256, 32, 7),
    ("gaussian", 400_000, 256, 64, 13)])
def test_window_rows_keep_the_main_fits_in_one_window(family, n, d, k,
                                                      windows):
    """The stat windows of the main fits' folds: one at 10^6 x 32 and for
    the linear fits; past d = 128 the windows that bound the partials."""
    fam = get_family(family)
    x = torch.empty((n, d), device="meta")
    assert len(fam.windows(x, k)) == windows


@pytest.mark.parametrize("k", [1, 17, 2048, 8192, 8193, 10_000, 16_384,
                               40_000])
def test_slot_windows_give_every_slot_one_window(k):
    wins = slot_windows(k)
    assert len(wins) == -(-k // MAX_K)
    seen = [s for k0, w in wins for s in range(k0, k0 + w)]
    assert seen == list(range(k))
    assert all(1 <= w <= MAX_K for _, w in wins)
    assert max(w for _, w in wins) - min(w for _, w in wins) <= 1


@pytest.mark.parametrize("d", [257, 300, 384, 1000])
def test_dense_panel_tile_covers_every_entry_once(d):
    """Past d = 256 a block of the dense oracle is one 128 x 128 tile (ta,
    tb) of one cluster's sxx, staging its two 128-column panels: thread
    (tx, ty)'s 8 x 8 entries at rows 128 ta + 4 ty + i (+ 64) and columns
    128 tb + 4 tx + j (+ 64) cover d x d once; the shared bytes are the
    d = 256 layout's."""
    for k in (1, 3, MAX_K):
        p = dense_plan(10_000, d, k)
        nt = -(-d // 128)
        assert p.panel and (p.bn, p.width) == (128, 256)
        assert p.gx == k * nt * nt
        assert p.smem == dense_plan(10_000, 256, k).smem <= SMEM_LIMIT
    seen = np.zeros((nt * 128, nt * 128), int)
    for ta in range(nt):
        for tb in range(nt):
            for ty in range(16):
                for tx in range(16):
                    rows = [128 * ta + 4 * ty + i + 64 * h for h in (0, 1)
                            for i in range(4)]
                    cols = [128 * tb + 4 * tx + j + 64 * h for h in (0, 1)
                            for j in range(4)]
                    seen[np.ix_(rows, cols)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("d", [257, 384, 1000])
def test_sub_assign_panels_chain_each_lane_in_column_order(d):
    """Past d = 256 ``sub_assign_gauss`` streams a sub-factor in
    ceil(d / 256) column panels of the d = 256 layout: lane l's registers
    over the panels are columns l + 32 t, t = 0, 1, .. in order (the
    d <= 256 warp layout's chain, carried from panel to panel), and the
    lanes own every column once."""
    npan = -(-d // 256)
    assert assign.sub_plan(4097, d, 17).dp == 256
    owned = []
    for lane in range(32):
        cols = [256 * pn + sub_col(256, lane, k) for pn in range(npan)
                for k in range(8)]
        assert cols == [lane + 32 * t for t in range(8 * npan)]
        owned += cols
    assert sorted(owned) == list(range(256 * npan))


def _family_state(fam, x, y, k, seed):
    """A sweep's operands at points x: every cluster and sub-cluster at the
    posterior mean of the true labels y and a random split."""
    g = torch.Generator().manual_seed(seed)
    n = x.shape[0]
    valid = torch.ones(n)
    lab = torch.as_tensor(y).to(torch.int32)
    sub = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    prior = fam.build_prior(DPMMConfig(component=fam.name),
                            x.mean(dim=0, keepdim=True))
    sub_stats = fam.stats_from_labels(x, valid, lab, sub, k)
    stats = tree_map(lambda a: a.sum(dim=1), sub_stats)
    live = stats.n > 0
    logw = torch.where(live, torch.log(stats.n.clamp(min=1) / n), -1e30)
    return (valid, fam.expected_params(prior, stats),
            fam.expected_params(prior, sub_stats), logw,
            torch.full((k, 2), math.log(0.5)), live,
            torch.arange(n, dtype=torch.int64) + 5,
            torch.tensor([9, 4_000_000_001]), torch.tensor([3, 17])), lab, sub


@pytest.mark.parametrize("component,make,d", [
    ("gaussian", generate_gmm, 4), ("multinomial", generate_mnmm, 8),
    ("diag_gaussian", generate_gmm, 4)])
def test_windowed_folds_are_the_unwindowed_folds_bitwise(monkeypatch,
                                                         component, make, d):
    fam = get_family(component)
    n, k = 5 * STATS_BLOCK, 6
    x_np, y = make(n, d, 4, seed=1)
    x = torch.as_tensor(x_np)
    st, lab, sub = _family_state(fam, x, y, k, seed=2)
    valid = st[0]
    acc0 = lambda: fam.empty_stats((k, 2), d, "cpu")
    assert len(fam.windows(x, k)) == 1
    whole = fam.sweep(x, *st, k, acc0())
    whole_stats = fam.stats_from_labels(x, valid, lab, sub, k, acc=acc0())
    monkeypatch.setattr(labelstats, "WINDOW_BYTES", 1)
    assert fam.windows(x, k) == [(a, a + STATS_BLOCK)
                                 for a in range(0, n, STATS_BLOCK)]
    win = fam.sweep(x, *st, k, acc0())
    win_stats = fam.stats_from_labels(x, valid, lab, sub, k, acc=acc0())
    assert torch.equal(win[0], whole[0]) and torch.equal(win[1], whole[1])
    for a, b in ((win[2], whole[2]), (win_stats, whole_stats)):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))


def _refuse(*args):
    raise AssertionError("the fused sweep ran")


@pytest.mark.parametrize("component,make", [("gaussian", generate_gmm),
                                            ("multinomial", generate_mnmm)])
def test_sweep_declines_slabs_past_the_one_read_kernels(component, make):
    """A slab of more than 2048 slots runs ``sweep_ref`` (the reference's
    K-block-tiled sweep takes any K); 2048 slots still run the fused
    sweep. The rule reads the shape only."""
    base = get_family(component)
    fam = dataclasses.replace(base, fused_sweep=_refuse)
    x_np, y = make(64, 2, 2, seed=3)
    x = torch.as_tensor(x_np)
    for k in (SWEEP_MAX_K + 1, SWEEP_MAX_K):
        st, _, _ = _family_state(base, x, y, k, seed=4)
        acc = lambda: base.empty_stats((k, 2), 2, "cpu")
        if k > SWEEP_MAX_K:
            got = fam.sweep(x, *st, k, acc())
            want = base.sweep_ref(x, *st, k, acc())
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        else:
            with pytest.raises(AssertionError, match="fused sweep ran"):
                fam.sweep(x, *st, k, acc())


def test_label_fold_and_step_f_match_jax_at_d260():
    d, k, n = 260, 3, 400
    rng = np.random.default_rng(260)
    f32 = np.float32
    x = (rng.normal(size=(n, d)) * 2).astype(f32)
    labels = rng.integers(0, k, n).astype(np.int32)
    sublabels = rng.integers(0, 2, n).astype(np.int32)
    valid = (rng.random(n) < 0.9).astype(f32)
    smu = (rng.normal(size=(k, 2, d)) * 0.3).astype(f32)
    schol = (np.tril(rng.normal(size=(k, 2, d, d)) * 0.02)
             + np.eye(d)).astype(f32)
    sld = rng.normal(size=(k, 2)).astype(f32)
    sublogw = np.log(rng.dirichlet(np.ones(2), size=k)).astype(f32)
    gidx = (np.arange(n) + 11).astype(np.uint32)
    kzb = np.array([0xFFFFFFF0, 5], np.uint32)
    j = jnp.asarray
    jfam = jget_family("gaussian")
    jstats = jfam.stats_from_labels(j(x), j(valid), j(labels), j(sublabels),
                                    k)
    jsub = jfam.sub_assign(j(x), jniw.GaussParams(j(smu), j(schol), j(sld)),
                           j(sublogw), j(labels), j(gidx), j(kzb))
    t = torch.as_tensor
    i64 = lambda v: t(v.astype(np.int64))
    stats = GAUSSIAN.stats_from_labels(t(x), t(valid), t(labels),
                                       t(sublabels), k)
    assert isinstance(stats, GaussStats) and stats.sxx.shape == (k, 2, d, d)
    assert torch.equal(stats.n, t(np.array(jstats.n)))
    for name in ("sx", "sxx"):
        got, want = getattr(stats, name), t(np.array(getattr(jstats, name)))
        assert bool(((got - want).abs()
                     <= 1e-5 * want.abs() + 1e-3).all()), name
    args = (t(x), t(smu), t(schol), t(sld), t(sublogw), t(labels), i64(gidx),
            i64(kzb))
    sub = GAUSSIAN.sub_assign(t(x), GaussParams(*args[1:4]), args[4],
                              args[5], args[6], args[7])
    bad, not_ties = assign.sub_assign_mismatches(
        True, args, sub, t(np.array(jsub)), TIE_RTOL)
    assert not_ties == 0 and bad <= 0.001 * n, (bad, not_ties)
    assert 0.1 < float(sub.float().mean()) < 0.9


def test_fold_plain_path_is_the_per_field_loop_bitwise():
    g = torch.Generator().manual_seed(21)
    nb, k, d = 37, 5, 3
    moments = torch.randn(nb, k, 2, 2 * d, generator=g) * 1e4
    accs = [torch.randn(k, 2, generator=g) * 1e3,
            torch.randn(k, 2, d, generator=g) * 1e3,
            torch.randn(k, 2, d, generator=g) * 1e3]
    parts = [torch.randn(nb, k, 2, generator=g) * 1e4,
             moments[..., :d], moments[..., d:]]
    want = [fold.fold_partials_plain(a, p) for a, p in zip(accs, parts)]
    got = fold.fold_fields_plain(accs, parts)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    acc = GaussStats(*accs[:2], torch.randn(k, 2, d, d, generator=g))
    part = GaussStats(parts[0], parts[1],
                      torch.randn(nb, k, 2, d, d, generator=g))
    out = labelstats.fold_stats(acc, part)
    loop = tree_map2(fold.fold_partials_plain, acc, part)
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(loop, f.name))


@pytest.mark.parametrize("view", ["contiguous", "low_half", "high_half",
                                  "one_slot", "transposed"])
def test_row_layout_addresses_every_element(view):
    """The fold kernel reads element j of block b at b bstride + (j / len)
    rstride + j % len of the partials' storage: a contiguous field, either
    half of the diagonal Gaussian's moment array, or None for strides of
    another form (read through a contiguous copy)."""
    nb, k, d = 4, 3, 5
    base = torch.arange(nb * k * 2 * 2 * d, dtype=torch.float32)
    m4 = base.view(nb, k, 2, 2 * d)
    parts = {"contiguous": m4, "low_half": m4[..., :d],
             "high_half": m4[..., d:], "one_slot": m4[:, :1, :, d:],
             "transposed": m4.transpose(1, 2)}[view]
    layout = fold.row_layout(parts)
    if view == "transposed":
        assert layout is None
        return
    bstride, length, rstride = layout
    off = parts.storage_offset()
    for b in range(nb):
        flat = parts[b].reshape(-1)
        for j in range(flat.numel()):
            at = off + b * bstride + (j // length) * rstride + j % length
            assert base[at] == flat[j]


@pytest.mark.parametrize("component,make", [("gaussian", generate_gmm),
                                            ("multinomial", generate_mnmm)])
def test_merges_past_the_all_pairs_batch_score_live_pairs_alike(
        monkeypatch, component, make):
    """``propose_merges`` scores only the pairs of live clusters, in
    batches of at most MERGE_PAIR_BYTES of merged stats, each with its own
    uniform: the same merge decision as scoring every pair i < j of the K
    slots and walking the accepted ones by descending log H (the
    reference's walk), with the default batches and with one pair a
    batch."""
    from repro_torch.core import splitmerge
    fam = get_family(component)
    k, d = 24, 3
    x_np, y = make(3000, d, 4, seed=5)
    x = torch.as_tensor(x_np)
    g = torch.Generator().manual_seed(6)
    # each true cluster over three slots: its three pairs would merge and
    # share clusters, so the thinning keeps one of them
    slots = torch.randperm(k, generator=g)[:12].reshape(4, 3)
    lab = slots[torch.as_tensor(y).long(),
                torch.randint(0, 3, (3000,), generator=g)].to(torch.int32)
    sub = torch.zeros_like(lab)
    stats = tree_map(lambda a: a.sum(dim=1), fam.stats_from_labels(
        x, torch.ones(3000), lab, sub, k))
    active = stats.n > 0
    prior = fam.build_prior(DPMMConfig(component=component),
                            x.mean(dim=0, keepdim=True))
    u = torch.rand(k * (k - 1) // 2, generator=g).clamp(min=1e-12)
    # every pair scored, then the greedy disjoint walk
    iu, ju = torch.triu_indices(k, k, 1)
    take = lambda i: tree_map(lambda s: s[i], stats)
    log_h = splitmerge.log_hastings_merge(prior, fam, take(iu), take(ju),
                                          10.0)
    accept = active[iu] & active[ju] & (torch.log(u) < log_h)
    taken, keep = set(), torch.zeros(iu.shape[0], dtype=torch.bool)
    for p in sorted(torch.nonzero(accept).flatten().tolist(),
                    key=lambda p: -float(log_h[p])):
        a, b = int(iu[p]), int(ju[p])
        if a not in taken and b not in taken:
            taken |= {a, b}
            keep[p] = True
    into = torch.arange(k)
    into[ju[keep]] = iu[keep]
    absorbed = torch.zeros(k, dtype=torch.bool)
    absorbed[ju[keep]] = True
    want = splitmerge.MergeDecision(
        merged=torch.isin(torch.arange(k), torch.tensor(sorted(taken),
                                                        dtype=torch.int64)),
        into=into, side=absorbed.to(torch.int64),
        new_active=active & ~absorbed)
    assert int(want.merged.sum()) >= 4
    for pair_bytes in (splitmerge.MERGE_PAIR_BYTES, 1):
        monkeypatch.setattr(splitmerge, "MERGE_PAIR_BYTES", pair_bytes)
        got = splitmerge.propose_merges(u, active, stats, prior, fam, 10.0)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name))
