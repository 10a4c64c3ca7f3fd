"""Split ``sweep_linear``'s time by phase, and A/B its layout choices, by
building variants of ``csrc/sweep_linear.cu`` and timing them in turns.

    python3 tools/ablate_linear.py [--rounds 3] [--runs 20]
        [--out RESULT.json]

Each variant is this checkout's source with one textual change (a part cut
out, or a layout choice swapped) and is built by its own nvcc, all in
parallel, into ``build/ablate_linear/``. The variants:

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
live) and a Poisson state (10^6 x 32, 32 slots, 16 live). Each reading
is ``chip_smoke.py`` ``run_ms``'s per-call device time of ``--runs``
back-to-back calls (both launches); the variants run in turns (all in
order, then in reverse, for ``--rounds`` rounds) and the medians are
printed as one JSON line a case, with the card's name and power limit.
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

SRC = build.CSRC / "sweep_linear.cu"
# (old, new, count): each old string must occur exactly count times
VARIANTS = {
    "full": (),
    "tile4": (("constexpr int TI = BM / 32;", "constexpr int TI = BM / 64;",
               1),
              ("float acc[TI][8];", "float acc[TI][16];", 1),
              ("for (int j = 0; j < 8; ++j)", "for (int j = 0; j < 16; ++j)",
               3),
              ("tx = tid & 7, ty = tid >> 3;", "tx = tid & 3, ty = tid >> 2;",
               1),
              ("(nac + 7) / 8;", "(nac + 3) / 4;", 1),
              ("ty + 32 * i", "ty + 64 * i", 2),
              ("tx + 8 * j", "tx + 4 * j", 2)),
    "bm64": (("return ((long long)n + 127) / 128 >= 2 * 132 ? 128 : 64;",
              "return 64;", 1),),
    "bm128": (("return ((long long)n + 127) / 128 >= 2 * 132 ? 128 : 64;",
               "return 128;", 1),),
    "no_product": (("for (int c = 0; c < DC; c += 4) {",
                    "for (int c = 0; c < 0; c += 4) {", 1),),
    "no_draws": (("gumbel(kz0, kz1, gs[p], (uint32_t)__ldg(slots + c))",
                  "0.f", 1),
                 ("pair_walk(np * ni, ni,", "pair_walk(0, ni,", 1)),
    "no_f": (("for (int e = tid; e < 2 * np; e += LE_THREADS) {\n"
              "      const int q = e % np",
              "for (int e = tid; e < 0; e += LE_THREADS) {\n"
              "      const int q = e % np", 1),
             ("for (int e0 = 8 * warp; e0 < np;",
              "for (int e0 = 8 * warp; e0 < 0;", 1)),
    "fold_no_x": (("*reinterpret_cast<const float4*>(f + (size_t)p * dp + a);",
                   "make_float4(wp, 1.f, 2.f, (float)p);", 1),
                  ("f[(size_t)p * dp + a]", "(float)p", 1)),
    "no_fold": (("sweep_linear_fold<<<grid, FOLD_THREADS, smem_f, s>>>(\n"
                 "      feats, n, dp, labels, sublabels, valid, K, n2, sf2);",
                 "(void)grid;", 1),),
}
SAME_FUNCTION = ("tile4", "bm64", "bm128")
FORCED_TILE = {"bm64": 64, "bm128": 128}
# (name, family, generator, N, d, true clusters, seed, compact slots)
CASES = (("multinomial_17", "multinomial", "generate_mnmm", 1_000_000, 128,
          17, 1, 64),
         ("multinomial_16", "multinomial", "generate_mnmm", 1_000_000, 128,
          16, 1, 64),
         ("news20", "multinomial", "generate_mnmm", 11_314, 20_000, 20, 0,
          32),
         ("poisson", "poisson", "generate_pmm", 1_000_000, 32, 16, 1, 32))


def variant_source(text: str, edits) -> str:
    for old, new, count in edits:
        if text.count(old) != count:
            raise SystemExit(f"ablate_linear: {old!r} occurs "
                             f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    return text


def build_all(out: Path) -> dict:
    text = SRC.read_text()
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, edits in VARIANTS.items():
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(text, edits))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *flags, "-I", str(build.CSRC), "-o",
             str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"ablate_linear: {name} did not build\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).sweep_linear_launch
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in "piipppppi" + "p" * 7 + "iiiii" + "p" * 5]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def case_call(fn, args, bm: int):
    """A closure that runs one call of the variant ``fn`` at tile ``bm``
    and its output tensors."""
    (feats, w, const, logw, active, subw, subconst, sublogw, valid, gidx,
     kz, kzb, slots) = args
    n, dp = feats.shape
    k = w.shape[0]
    plan = sweep.linear_plan(n, dp, k)
    smem_e = 4 * (sweep.LE_STAGES[bm] * (bm + sweep.LE_BK) * sweep.LE_FSTR
                  + 2 * k + 1 + 32 + 7 * bm)
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
        err = fn(*argv, ctypes.c_void_p(torch.cuda.current_stream()
                                        .cuda_stream))
        if err:
            raise RuntimeError(f"sweep_linear_launch returned {err}")
    return call, (labels, sub, n2, sf2)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_linear: no CUDA device")
    dev = torch.device("cuda")
    libs = build_all(ROOT / "build" / "ablate_linear")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"card": card.strip().splitlines()[0], "cases": {}}
    for cname, fam, make, n, d, k_true, seed, k_c in CASES:
        x, y = getattr(synthetic, make)(n, d, k_true, seed=seed)
        args = linear_sweep_args(get_family(fam), torch.as_tensor(x,
                                 device=dev), y, k_c, dev)
        n_, dp = args[0].shape
        plan_bm = sweep.linear_plan(n_, dp, k_c).bm
        calls, outs = {}, {}
        for name, fn in libs.items():
            calls[name], outs[name] = case_call(
                fn, args, FORCED_TILE.get(name, plan_bm))
            calls[name]()
        torch.cuda.synchronize()
        bits = {name: all(torch.equal(u, v) for u, v in
                          zip(outs[name], outs["full"]))
                for name in SAME_FUNCTION}
        order = list(libs)
        ms = {name: [] for name in order}
        for _ in range(a.rounds):
            for name in order + order[::-1]:
                ms[name].append(run_ms(calls[name], a.runs)[0])
        result["cases"][cname] = {
            "n": n_, "dp": dp, "k": k_c, "live": int(args[4].sum()),
            "plan_bm": plan_bm, "bitwise_full": bits,
            "device_ms": {k: statistics.median(v) for k, v in ms.items()},
            "spread_ms": {k: [min(v), max(v)] for k, v in ms.items()}}
        print(json.dumps({cname: result["cases"][cname]}), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))
    print(result["card"])
    print(json.dumps({"ok": all(all(c["bitwise_full"].values())
                                for c in result["cases"].values())}))


if __name__ == "__main__":
    main()
