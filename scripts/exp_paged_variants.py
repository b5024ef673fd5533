"""Design variants and knock-outs of paged_attention_any (K6's general
kernel), built beside each other and timed in turns on one CUDA card.

    python3 scripts/exp_paged_variants.py [variant ...]

Each variant is a list of text edits of csrc/paged_attention.cu, built by
scripts/kernel_variants.py (every other source compiles once), and
optionally a plan (splits, stages) other than ops/paged_attention.py's
_paged_plan gives. Each is timed through the package's own paged_attention
wrapper (its library swapped for the variant's) at chip_smoke.py phase
2's shapes (B=32, 4 pages of 128 tokens a sequence, its lengths; the
decode's own call, append_kv and no window) in the CASES below, and at
phase 11's steady decode ("openllama decode", chip_smoke.py's
openllama_decode_call: its 26-layer pool, 16 pages a sequence, lengths of
56-95 tokens, the calls taking the layers in turns as a step does): the
device time a call by CUDA events over the replay of a CUDA graph of 100
calls (and at the decode call the wrapper's host time a call, by
chip_smoke.py's host_us),
median of 5 replays, the variants in turns, ROUNDS rounds, the median
printed. A variant whose results are right (every case within phase 2's
limits of the plain version) says so; knock-outs are not. With variant
names as arguments, only those are built and timed beside "as built".

Not here: scores on mma.sync m16n8k16 with the query heads as M rows, a
design for large groups; the FMA path met its aims at MQA 32/1 and Gemma
8/1 (PERF.md).
"""

import importlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import kernel_variants  # noqa: E402
from lamp_tpu_torch.ops import _build  # noqa: E402

# the module (ops/__init__.py binds the package's name to the function)
PA = importlib.import_module("lamp_tpu_torch.ops.paged_attention")

ROUNDS = 3
CASES = ("openllama d100", "openllama d100 e4m3", "openllama d100 f64",
         "gemma d256", "405B 128/8", "MQA 32/1", "d80", "128/1 d256")

NO_SCORES = ("        for (int u = part; u < nu; u += ds) {",
             "        for (int u = part; u < 0; u += ds) {")
NO_PRODUCTS = ("      for (; j + sb < n; j += 2 * sb) {",
               "      for (j = n; j + sb < n; j += 2 * sb) {")
# (edits, the plan's (splits, stages) -> the variant's, or None)
VARIANTS = {
    "as built": ([], None),
    "no split": ([], lambda splits, stages: (1, stages)),
    "splits of two pages": ([], lambda splits, stages: (2, stages)),
    "128 threads always": ([("pl.nt = qpk == 1 && asz == 4 ? 128 : kAnyThreads;",
                             "pl.nt = 128;")], None),
    "256 threads always": ([("pl.nt = qpk == 1 && asz == 4 ? 128 : kAnyThreads;",
                             "pl.nt = kAnyThreads;")], None),
    "tiles of 128": ([("for (int lt = 6; lt >= 4; --lt) {",
                       "for (int lt = 7; lt >= 4; --lt) {")], None),
    "one stage": ([], lambda splits, stages: (splits, 1)),
    "two stages": ([], lambda splits, stages: (splits, 2)),
    "three stages": ([], lambda splits, stages: (splits, 3)),
    # rows copied by cp.async pieces of their alignment instead of TMA
    # boxes
    # TMA boxes of a whole tile (or page) of rows, whatever the band holds
    "boxes of a tile": ([("c.box = std::min(kBoxRows, std::min(tt, page_size));",
                          "c.box = std::min(tt, page_size);")], None),
    "no TMA": ([("pl.tma = pl.tma != 0 && VB >= 4 &&",
                 "pl.tma = false && VB >= 4 &&")], None),
    # the partials stay where they are: each owner adds what its recv
    # holds (results wrong), the exchange's cost shows
    "no cluster sum": ([("hopper::mbar_arrive_tx(comb, cs * nown * pl.hw * 4);",
                         "hopper::mbar_arrive_tx(comb, 0);"),
                        ("    for (int r = 0; r < cs; ++r) {\n"
                         "      const int words",
                         "    for (int r = 0; r < 0; ++r) {\n"
                         "      const int words")], None),
    "plain launch without a split": ([("cfg.numAttrs = 1;",
                                       "cfg.numAttrs = splits > 1 ? 1 : 0;")],
                                     None),
    # a launch by <<<>>> without a split (cudaLaunchKernel, no launch
    # attributes): the host's time a call
    "chevron launch without a split": ([(
        "  const cudaError_t err = cudaLaunchKernelEx(\n      &cfg, kernel, ",
        "  if (splits == 1) {\n"
        "    kernel<<<cfg.gridDim, cfg.blockDim, pl.smem, stream>>>(\n"
        "        static_cast<const T*>(q), static_cast<const KV*>(k),\n"
        "        static_cast<const KV*>(v), static_cast<const T*>(new_k),\n"
        "        static_cast<const T*>(new_v), page_table, lengths, windows,\n"
        "        static_cast<T*>(out), num_heads, num_kv_heads, D, page_size,\n"
        "        pages_per_seq, page_stride, page_offset, static_window,\n"
        "        static_cast<A>(sm_scale), pl, maps[0], maps[1]);\n"
        "    return cudaGetLastError();\n"
        "  }\n"
        "  const cudaError_t err = cudaLaunchKernelEx(\n      &cfg, kernel, ")],
        None),
    "tiles of 32": ([("for (int lt = 6; lt >= 4; --lt) {",
                      "for (int lt = 5; lt >= 4; --lt) {")], None),
    "one head a score thread": ([("c.hb = std::min(kMaxHb, qh);",
                                  "c.hb = 1;")], None),
    "no scores": ([NO_SCORES], None),
    "no output products": ([NO_PRODUCTS], None),
    "loads only": ([NO_SCORES, NO_PRODUCTS], None),
}


def inputs():
    """Phase 2's table and lengths, and each case's pool, q and append
    rows (chip_smoke.py's K6_WIDE)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(0)
    b, pps = 32, cs.CTX // cs.PAGE
    table = torch.as_tensor(np.stack([
        rng.choice(np.arange(1, cs.TOTAL_PAGES), pps, replace=False)
        for _ in range(b)]).astype(np.int32), device=dev)
    edge = [0, 1, 127, 128, 129, 255, 511]
    lengths = torch.as_tensor(np.asarray(
        edge + list(rng.randint(0, pps * cs.PAGE, b - len(edge))), np.int32),
        device=dev)
    out = {}
    for name, h, hkv, d, qdt, pdt in cs.K6_WIDE:
        if name not in CASES:
            continue
        pool = torch.randn((cs.TOTAL_PAGES, 2, cs.PAGE, hkv * d),
                           generator=gen, device=dev).to(pdt)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(qdt)
        new = tuple(torch.randn((b, hkv * d), generator=gen,
                                device=dev).to(qdt) for _ in range(2))
        out[name] = (q, pool, hkv, new, table, lengths, [0])
    # phase 11's steady decode call, the layers in turns
    out["openllama decode"] = cs.openllama_decode_call(gen, rng, b)
    return out


def main(names) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("exp_paged_variants: needs a CUDA card")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    chosen = {n: VARIANTS[n] for n in VARIANTS
              if not names or n in names or n == "as built"}
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    t0 = time.perf_counter()
    libs, logs = kernel_variants.build(
        "paged_attention.cu", {n: e for n, (e, _) in chosen.items()},
        _build._BUILD_DIR / "paged_variants")
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in chosen:
        for line in kernel_variants.spills(logs[name], "paged_attention_any"):
            print(f"  {name}: {line}", flush=True)
    cases = inputs()
    plan = PA._paged_plan
    times = {n: {c: [] for c in cases} for n in chosen}
    host = {n: [] for n in chosen}
    right = {}
    for rnd in range(ROUNDS):
        for name, (_, splits) in chosen.items():  # splits: the override
            _build.library = lambda lib=libs[name]: lib
            PA._paged_plan = plan if splits is None else (
                lambda *a, f=splits: f(*plan(*a)))
            for case, (q, pool, hkv, new, table, lengths,
                       offsets) in cases.items():
                def call(i=0):
                    return PA.paged_attention(
                        q, pool, None, table, lengths, num_kv_heads=hkv,
                        append_kv=new, page_offset=offsets[i % len(offsets)])

                if rnd == 0:
                    acc = torch.promote_types(q.dtype, torch.float32)
                    ref = PA.paged_attention_reference(
                        q.to(acc), pool if pool.element_size() == 1 else
                        pool[:cs.TOTAL_PAGES].to(acc), None,
                        table, lengths, num_kv_heads=hkv,
                        append_kv=tuple(x.to(acc) for x in new))
                    err = (call().to(acc) - ref).abs()
                    lim = cs.K6_TOL_F64 if q.dtype == torch.float64 else \
                        cs.ATOL + cs.RTOL * ref.abs()
                    right[name] = right.get(name, True) and \
                        not bool((err > lim).any())
                times[name][case].append(cs.graph_ms(call) * 1e3)
                if case == "openllama decode":
                    host[name].append(cs.host_us(call))
    PA._paged_plan = plan
    print(f"{'variant':26} " + " ".join(f"{c[:14]:>14}" for c in cases) +
          " host (decode)", flush=True)
    for name in chosen:
        row = " ".join(f"{np.median(times[name][c]):14.2f}" for c in cases)
        row += f" {np.median(host[name]):13.2f}"
        print(f"{name:26} {row}  (us a call; results "
              f"{'right' if right[name] else 'WRONG'})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
