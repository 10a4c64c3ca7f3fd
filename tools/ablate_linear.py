"""Split ``sweep_linear``'s time by phase, A/B its layout choices, and A/B
the layouts of its step (f) run alone (``sub_assign_linear``), by building
variants of the sources and timing them in turns.

    python3 tools/ablate_linear.py [--rounds 3] [--runs 20] [--steps-only]
        [--parent OTHER_CHECKOUT/src/repro_torch/csrc] [--out RESULT.json]

Each variant is this checkout's sources with textual changes (a part cut
out, or a layout choice swapped) in ``csrc/sweep_linear.cu``, the tile they
share (``csrc/linear_tile.cuh``), ``csrc/assign_linear.cu`` or
``csrc/sub_assign_linear.cu``, built by its own nvcc, all in parallel, into
``build/ablate_linear/<variant>/``. The sweep's variants:

- ``full``: the source as it is;
- ``tile4``: step (e)'s register tile with four slot columns a point row
  (points ty + 64 i, slots tx + 4 j; 16 or 17 live slots fill 4 or 5 of
  a thread's 16 columns) against eight (points ty + 32 i, slots tx + 8 j;
  2 or 3 of 8);
- ``bm64`` and ``bm128``: 64-point tiles (four-chunk ring, two blocks an
  SM) or 128-point ones (two-chunk ring, three an SM) at every N, the two
  sides of ``linear_plan``'s tile switch;
- ``no_product``: step (e) without its dot products (the chunks are still
  copied);
- ``no_draws``: step (e) without the Threefry draws (live slots' Gumbels 0,
  no top-bin test of the inactive slots);
- ``no_f``: step (f) without its two sums a point (the logits, draws and
  choice stay);
- ``fold_no_x``: the fold without its read of the features (a constant in
  their place): what reading x a second time costs;
- ``no_fold``: the first launch alone.

Only ``tile4``, ``bm64`` and ``bm128`` compute the same function; their
outputs (labels, sub-labels, n and sf partials) are compared with
``full``'s bit for bit. The cut variants give wrong answers by design
and are timing probes only. The operands are ``chip_smoke.py``'s
``linear_sweep_args`` (generator labels, a compact slab with the true
clusters live) at the multinomial fit's shape (10^6 x 128, 64 slots, 16
and 17 live), the 20newsgroups width (11,314 x 20,000, 32 slots, 20
live) and a Poisson state (10^6 x 32, 32 slots, 16 live).

Step (f) alone (``STEP_CASES``: the 8192-row multinomial and
diagonal-Gaussian serving steps, 32 slots with 17 live, the 20newsgroups
width, Poisson and diagonal-Gaussian 10^6 x 32 states, and 2e5 x 128 and
10^6 x 128 multinomial ones), ``sub_assign_linear`` under
``assign_linear``'s labels, on the plan (``f_plan``: runs of up to 32
consecutive points a warp in windows of ``LF_FW`` points, ``LF_MINB``
blocks an SM, tiles of up to 256 points, a thread a (point,
sub-cluster) up to d' = 32, on a kernel of its own) against:

- ``f_warp``: a warp's run at every d';
- ``f_stage``: the warp route with each tile's labels and Gumbel counters
  staged in shared memory behind a barrier (as the other routes);
- ``f_fw<W>_b<B>``: windows of W points at B blocks an SM (at most
  64 K / (256 B) registers a thread): a warp a point at six, windows of 2
  at five;
- ``f_unroll1`` / ``f_unroll2``: the window's feature loop (16-byte
  rows) unrolled once or twice, not as the compiler chooses;
- ``f_bm256`` / ``f_bm128``: the warp route on tiles of 256 points
  wherever they make LE_BLOCKS blocks, or never (runs of 16 a warp);
- ``f_parent``, with ``--parent DIR``: the ``sub_assign_linear.cu`` of
  another checkout's ``csrc`` (its own launcher: no plan arguments).

The variants of a set must give the same bits (``bitwise``). Each reading is
``chip_smoke.py`` ``run_ms``'s per-call device time of ``--runs``
back-to-back calls (all of a call's launches); the variants run in turns
(all in order, then in reverse, for ``--rounds`` rounds) and the medians
are printed as one JSON line a case, with the card's name and power limit.
Needs a CUDA card and nvcc.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import linear_sweep_args, run_ms  # noqa: E402
from repro_torch.core.family import get_family  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import build, sweep  # noqa: E402

TILE = "linear_tile.cuh"
SWEEP, ASSIGN = "sweep_linear.cu", "assign_linear.cu"
SUB = "sub_assign_linear.cu"
# (file, old, new, count): each old string must occur exactly count times
VARIANTS = {
    "full": (),
    "tile4": ((TILE, "constexpr int TI = BM / 32;",
               "constexpr int TI = BM / 64;", 1),
              (TILE, "float acc[TI][8];", "float acc[TI][16];", 1),
              (TILE, "for (int j = 0; j < 8; ++j)",
               "for (int j = 0; j < 16; ++j)", 3),
              (TILE, "tx = tid & 7, ty = tid >> 3;",
               "tx = tid & 3, ty = tid >> 2;", 1),
              (TILE, "(nac + 7) / 8;", "(nac + 3) / 4;", 1),
              (TILE, "ty + 32 * i", "ty + 64 * i", 2),
              (TILE, "tx + 8 * j", "tx + 4 * j", 2)),
    "bm64": ((SWEEP, "return ((long long)n + 127) / 128 >= LE_BLOCKS ? 128 "
              ": 64;", "return 64;", 1),),
    "bm128": ((SWEEP, "return ((long long)n + 127) / 128 >= LE_BLOCKS ? 128 "
               ": 64;", "return 128;", 1),),
    "no_product": ((TILE, "for (int c = 0; c < DC; c += 4) {",
                    "for (int c = 0; c < 0; c += 4) {", 1),),
    "no_draws": ((TILE, "gumbel(kz0, kz1, gs[p], (uint32_t)__ldg(a.slots + "
                  "c))", "0.f", 1),
                 (TILE, "pair_walk(np * ni, ni,", "pair_walk(0, ni,", 1)),
    "no_f": ((TILE, "e < 2 * np; e += LE_THREADS) {\n      const int q = "
              "e % np", "e < 0; e += LE_THREADS) {\n      const int q = "
              "e % np", 1),
             (TILE, "for (int e0 = FW * warp; e0 < np;",
              "for (int e0 = FW * warp; e0 < 0;", 1)),
    "fold_no_x": ((SWEEP, "*reinterpret_cast<const float4*>(f + (size_t)p * "
                   "dp + a);", "make_float4(wp, 1.f, 2.f, (float)p);", 1),
                  (SWEEP, "f[(size_t)p * dp + a]", "(float)p", 1)),
    "no_fold": ((SWEEP, "sweep_linear_fold<<<grid, FOLD_THREADS, smem_f, "
                 "s>>>(\n      feats, n, dp, labels, sublabels, valid, K, "
                 "n2, sf2);", "(void)grid;", 1),),
}
SAME_FUNCTION = ("tile4", "bm64", "bm128")
FORCED_TILE = {"bm64": 64, "bm128": 128}
_LF_TILE = "(m + 255) / 256 >= LF_BM256_BLOCKS ? 256"
_FW, _MINB = "constexpr int LF_FW = 4;", "constexpr int LF_MINB = 4;"
_VEC_LOOP = ("    for (int c = 4 * lane; c < dp; c += 128) {\n"
             "      float4 xv[FW];")


def _fw_minb(fw: int, minb: int):
    return ((SUB, _FW, f"constexpr int LF_FW = {fw};", 1),
            (SUB, _MINB, f"constexpr int LF_MINB = {minb};", 1))


STEP_VARIANTS = {
    "f_plan": (SUB, ()),
    "f_warp": (SUB, ((SUB, "f_thread != (dp <= LF_THREAD_DP ? 1 : 0)",
                      "f_thread != 0", 1),)),
    "f_stage": (SUB, ((TILE, "  return !e && route == F_WARP;",
                       "  return false;", 1),)),
    "f_fw1_b6": (SUB, _fw_minb(1, 6)),
    "f_fw2_b5": (SUB, _fw_minb(2, 5)),
    "f_unroll1": (SUB, ((TILE, _VEC_LOOP, "#pragma unroll 1\n" + _VEC_LOOP,
                         1),)),
    "f_unroll2": (SUB, ((TILE, _VEC_LOOP, "#pragma unroll 2\n" + _VEC_LOOP,
                         1),)),
    "f_bm256": (SUB, ((SUB, _LF_TILE, "(m + 255) / 256 >= LE_BLOCKS ? 256",
                       1),)),
    "f_bm128": (SUB, ((SUB, _LF_TILE, "(m + 255) / 256 >= INT_MAX ? 256",
                       1),)),
}


def step_plan(name: str, n: int, dp: int, k: int):
    """(bm, f_thread, smem) of a step-(f) variant at (n, d', k), as its
    source's launcher checks it."""
    from repro_torch.kernels import assign
    f_thread = assign.linear_sub_plan(n, dp, k).f_thread and name != "f_warp"
    bm = next((b for b in assign.LT_BM if -(-n // b) >= sweep.LE_BLOCKS),
              assign.LT_BM[-1])
    wide = {"f_bm256": sweep.LE_BLOCKS, "f_bm128": 2 ** 31}.get(
        name, assign.LF_BM256_BLOCKS)
    if not f_thread and -(-n // 256) >= wide:
        bm = 256
    return bm, f_thread, assign.lt_smem(False, True, bm, 1, k)


# (name, family, generator, N, d, true clusters, seed, compact slots)
CASES = (("multinomial_17", "multinomial", "generate_mnmm", 1_000_000, 128,
          17, 1, 64),
         ("multinomial_16", "multinomial", "generate_mnmm", 1_000_000, 128,
          16, 1, 64),
         ("news20", "multinomial", "generate_mnmm", 11_314, 20_000, 20, 0,
          32),
         ("poisson", "poisson", "generate_pmm", 1_000_000, 32, 16, 1, 32))


def variant_sources(edits) -> dict:
    """This checkout's linear sources with ``edits`` applied."""
    texts = {f: (build.CSRC / f).read_text()
             for f in (TILE, SWEEP, ASSIGN, SUB)}
    for f, old, new, count in edits:
        if texts[f].count(old) != count:
            raise SystemExit(f"ablate_linear: {old!r} occurs "
                             f"{texts[f].count(old)} times in {f}, not "
                             f"{count}")
        texts[f] = texts[f].replace(old, new)
    return texts


def build_all(out: Path, sweeps: bool = True, parent: str = "") -> dict:
    """Build every variant (``sweeps``: the sweep's too; ``parent``: the
    ``sub_assign_linear.cu`` of that csrc directory as ``f_parent``), each
    in a directory of its own with its patched tile beside it; returns
    each variant's launch function."""
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = ({name: (SWEEP, edits) for name, edits in VARIANTS.items()}
            if sweeps else {})
    jobs.update(STEP_VARIANTS)
    procs = {}
    for name, (src, edits) in jobs.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in variant_sources(edits).items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *flags, "-I", str(build.CSRC), "-o",
             str(d / "lib.so"), str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if parent:
        (out / "f_parent").mkdir(parents=True, exist_ok=True)
        procs["f_parent"] = subprocess.Popen(
            [build.nvcc(), *flags, "-I", parent, "-o",
             str(out / "f_parent" / "lib.so"), str(Path(parent) / SUB)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sigs = {SWEEP: ("sweep_linear_launch",
                    "piipppppi" + "p" * 7 + "iiiii" + "p" * 5),
            SUB: ("sub_assign_linear_launch", "piipippppp" + "iii" + "pp"),
            "parent": ("sub_assign_linear_launch", "piipippppp" + "pp")}
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"ablate_linear: {name} did not build\n{log}")
        symbol, sig = sigs[jobs[name][0] if name in jobs else "parent"]
        fn = getattr(ctypes.CDLL(str(out / name / "lib.so")), symbol)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in sig]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def step_call(name: str, fn, args):
    """A closure that runs one call of the step-(f) variant ``name`` on
    ``sweep_linear`` operands ``args``, under ``assign_linear``'s labels
    on them, and its output tensor."""
    from repro_torch.kernels import assign
    (feats, w, const, logw, active, subw, subconst, sublogw, _, gidx, kz,
     kzb, slots) = args
    n, dp = feats.shape
    k = w.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=feats.device)
    labels = assign.assign_linear_cuda(feats, w, const, logw, active, gidx,
                                       kz, slots)
    argv = (feats.data_ptr(), n, dp, labels.data_ptr(), k, subw.data_ptr(),
            subconst.data_ptr(), sublogw.data_ptr(), gidx.data_ptr(),
            kzb.data_ptr())
    if name != "f_parent":
        bm, f_thread, smem = step_plan(name, n, dp, k)
        argv += (bm, int(f_thread), smem)
    argv += (out.data_ptr(),)

    def call():
        # the operands the launch reads stay alive with the closure
        err = fn(*argv, _stream()) if labels is not None else 1
        if err:
            raise RuntimeError(f"{name}: launch returned {err}")
    return call, (out,)


def case_call(fn, args, bm: int):
    """A closure that runs one call of the variant ``fn`` at tile ``bm``
    and its output tensors."""
    (feats, w, const, logw, active, subw, subconst, sublogw, valid, gidx,
     kz, kzb, slots) = args
    n, dp = feats.shape
    k = w.shape[0]
    from repro_torch.kernels import assign
    plan = sweep.linear_plan(n, dp, k)
    smem_e = assign.lt_smem(True, True, bm, sweep.LE_STAGES[bm], k)
    dev = feats.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    sub = torch.empty_like(labels)
    n2 = torch.empty((plan.nsb, k, 2), device=dev)
    sf2 = torch.empty((plan.nsb, k, 2, dp), device=dev)
    argv = (feats.data_ptr(), n, dp, w.data_ptr(), const.data_ptr(),
            logw.data_ptr(), active.data_ptr(), slots.data_ptr(), k,
            subw.data_ptr(), subconst.data_ptr(), sublogw.data_ptr(),
            valid.data_ptr(), gidx.data_ptr(), kz.data_ptr(), kzb.data_ptr(),
            bm, smem_e, int(plan.f_thread), plan.fc, plan.smem_f,
            labels.data_ptr(), sub.data_ptr(), n2.data_ptr(), sf2.data_ptr())

    def call():
        err = fn(*argv, _stream())
        if err:
            raise RuntimeError(f"sweep_linear_launch returned {err}")
    return call, (labels, sub, n2, sf2)


STEP_CASES = (("serve_multinomial", "multinomial", "generate_mnmm", 8192,
               128, 17, 2, 32),
              ("serve_diag_gaussian", "diag_gaussian", "generate_gmm", 8192,
               32, 17, 2, 32),
              ("news20", "multinomial", "generate_mnmm", 11_314, 20_000, 20,
               0, 32),
              ("poisson", "poisson", "generate_pmm", 1_000_000, 32, 16, 1,
               32),
              ("diag_gaussian", "diag_gaussian", "generate_gmm", 1_000_000,
               32, 16, 1, 32),
              ("multinomial_2e5", "multinomial", "generate_mnmm", 200_000,
               128, 16, 1, 32),
              ("multinomial_1e6", "multinomial", "generate_mnmm", 1_000_000,
               128, 16, 1, 32))


def turns(calls: dict, rounds: int, runs: int) -> dict:
    """Per-call device ms of each call, in turns: medians and spreads."""
    order = list(calls)
    ms = {name: [] for name in order}
    for _ in range(rounds):
        for name in order + order[::-1]:
            ms[name].append(run_ms(calls[name], runs)[0])
    return {"device_ms": {k: statistics.median(v) for k, v in ms.items()},
            "spread_ms": {k: [min(v), max(v)] for k, v in ms.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--steps-only", action="store_true",
                    help="time step (f) alone, not the sweep's variants")
    ap.add_argument("--parent", default="",
                    help="another checkout's csrc directory: its "
                         "sub_assign_linear.cu joins step (f)'s set")
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_linear: no CUDA device")
    dev = torch.device("cuda")
    libs = build_all(ROOT / "build" / "ablate_linear",
                     sweeps=not a.steps_only, parent=a.parent)
    step_set = list(STEP_VARIANTS) + (["f_parent"] if a.parent else [])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"card": card.strip().splitlines()[0], "cases": {},
              "steps": {}}
    for cname, fam, make, n, d, k_true, seed, k_c in (
            () if a.steps_only else CASES):
        x, y = getattr(synthetic, make)(n, d, k_true, seed=seed)
        args = linear_sweep_args(get_family(fam), torch.as_tensor(x,
                                 device=dev), y, k_c, dev)
        n_, dp = args[0].shape
        plan_bm = sweep.linear_plan(n_, dp, k_c).bm
        calls, outs = {}, {}
        for name in VARIANTS:
            calls[name], outs[name] = case_call(
                libs[name], args, FORCED_TILE.get(name, plan_bm))
            calls[name]()
        torch.cuda.synchronize()
        bits = {name: all(torch.equal(u, v) for u, v in
                          zip(outs[name], outs["full"]))
                for name in SAME_FUNCTION}
        result["cases"][cname] = {
            "n": n_, "dp": dp, "k": k_c, "live": int(args[4].sum()),
            "plan_bm": plan_bm, "bitwise_full": bits,
            **turns(calls, a.rounds, a.runs)}
        print(json.dumps({cname: result["cases"][cname]}), flush=True)
    for cname, fam, make, n, d, k_true, seed, k_c in STEP_CASES:
        x, y = getattr(synthetic, make)(n, d, k_true, seed=seed)
        args = linear_sweep_args(get_family(fam), torch.as_tensor(x,
                                 device=dev), y, k_c, dev)
        n_, dp = args[0].shape
        r = {"n": n_, "dp": dp, "k": k_c, "live": int(args[4].sum()),
             "plan": step_plan("f_plan", n_, dp, k_c)[:2]}
        calls, outs = {}, {}
        for name in step_set:
            calls[name], outs[name] = step_call(name, libs[name], args)
            calls[name]()
        torch.cuda.synchronize()
        r["f"] = {"bitwise": all(torch.equal(outs["f_plan"][0], o[0])
                                 for o in outs.values()),
                  **turns(calls, a.rounds, a.runs)}
        del calls, outs
        result["steps"][cname] = r
        print(json.dumps({cname: r}), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))
    print(result["card"])
    print(json.dumps({"ok": all(all(c["bitwise_full"].values())
                                for c in result["cases"].values())
                      and all(v["bitwise"] for c in result["steps"].values()
                              for v in c.values() if isinstance(v, dict))}))


if __name__ == "__main__":
    main()
