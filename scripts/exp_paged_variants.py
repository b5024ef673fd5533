"""Design variants and knock-outs of K6's kernels (paged_attention_fixed
and paged_attention_any), built beside each other and timed in turns on
one CUDA card.

    python3 scripts/exp_paged_variants.py [variant ...]

Each variant is a list of text edits of csrc/paged_attention.cu, built by
scripts/kernel_variants.py (every other source compiles once), and
optionally a plan (splits, stages) other than ops/paged_attention.py's
_paged_plan gives. Each is timed through the package's own paged_attention
wrapper (its library swapped for the variant's) at chip_smoke.py phase
2's shapes (B=32, 4 pages of 128 tokens a sequence, its lengths; the
decode's own call, append_kv and no window) in the CASES below (phase 2's
own serving-layer calls on the bf16 and e4m3 pools among them), at phase
3's decode call ("serving decode", bf16 and e4m3: chip_smoke.py's
serving_decode_call, lengths of 56-95, 4 page tables x 12 layers in
turns, cold) and at phase 11's ("openllama decode", chip_smoke.py's
openllama_decode_call: its 26-layer pool, 16 pages a sequence, lengths of
56-95 tokens, the calls taking the layers in turns as a step does): the
device time a call by CUDA events over the replay of a CUDA graph of 100
calls (and at phase 11's decode call the wrapper's host time a call, by
chip_smoke.py's host_us), median of 5 replays, the variants in turns,
ROUNDS rounds, the median printed. A variant whose results are right
(every case within phase 2's limits of the plain version) says so;
knock-outs are not. Each build's ptxas stack-frame and spill lines of both
kernels are printed. With variant names as arguments, only those are built
and timed beside "as built".

The fixed kernel's variants: the yardstick "forced any" (these shapes
routed to paged_attention_any), its design choices (V's rows issued once
a box is scored; one or two boxes a warp before the length; no split; FFMA products for 16-bit q; a cluster
rank of 4 warps a split; rings of 16 KB) and knock-outs of its products
("fixed: loads only"), of the cluster's sum ("fixed: no cluster sum") and
of all but the launch ("fixed: exits at once").
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
         "gemma d256", "405B 128/8", "MQA 32/1", "d80", "128/1 d256",
         "d128 32/32")

NO_SCORES = ("        for (int u = part; u < nu; u += ds) {",
             "        for (int u = part; u < 0; u += ds) {")
NO_PRODUCTS = ("      for (; j + sb < n; j += 2 * sb) {",
               "      for (j = n; j + sb < n; j += 2 * sb) {")
FIXED_LOADS_ONLY = (
    "    hopper::mbar_wait(&full[s], (j / NS) & 1);\n",
    "    hopper::mbar_wait(&full[s], (j / NS) & 1);\n"
    "    if (true) {\n"
    "      __syncwarp();\n"
    "      if (lane == 0 && j + NS < nbox) issue(j + NS, box_tok(j + NS), pnext);\n"
    "      continue;\n"
    "    }\n")
# K's rows first, V's issued once the box is scored (the design before:
# V waited for the scores), on a second phase of the slot's barrier; the
# 16-bit products' path
V_AFTER_SCORES = [
    ("  auto issue = [&](int j, int t0, int pgid) {",
     "  __shared__ int vrow_all[kFixWarps * kFixMaxSlots];\n"
     "  int* vrow = vrow_all + warp * kFixMaxSlots;\n"
     "  auto issue = [&](int j, int t0, int pgid) {"),
    ("    hopper::mbar_arrive_tx(&full[s], S::SLOT);",
     "    hopper::mbar_arrive_tx(&full[s], S::HALF);\n"
     "    vrow[s] = static_cast<int>(row);"),
    ("      hopper::tma_load_2d(st + S::HALF + c * S::BOX, &tm_v, &full[s],\n"
     "                          col + c * S::CW / sz, static_cast<int>(row));\n",
     ""),
    ("    hopper::mbar_wait(&full[s], (j / NS) & 1);",
     "    hopper::mbar_wait(&full[s], 0);"),
    ("      // V rows outside the band read as 0 (a box's other rows may hold",
     "      __syncwarp();\n"
     "      if (lane == 0) {\n"
     "        hopper::fence_proxy_async();\n"
     "        hopper::mbar_arrive_tx(&full[s], S::HALF);\n"
     "        for (int c = 0; c < S::NC; ++c)\n"
     "          hopper::tma_load_2d(const_cast<unsigned char*>(vs) + c * S::BOX,\n"
     "                              &tm_v, &full[s], col + c * S::CW / sz, vrow[s]);\n"
     "      }\n"
     "      hopper::mbar_wait(&full[s], 1);\n"
     "      // V rows outside the band read as 0 (a box's other rows may hold"),
]
# (edits, the plan's (splits, stages) -> the variant's, or None)
VARIANTS = {
    "as built": ([], None),
    # the fixed kernel's shapes on the general kernel: the yardstick
    "forced any": ([(
        "const bool fixed = num_heads / num_kv_heads <= kMaxQ && "
        "page_size % kFixBox == 0;", "const bool fixed = false;")], None),
    "V after the scores": (V_AFTER_SCORES, None),
    "first box before the length": ([("constexpr int kFixSpec = 0;",
                                      "constexpr int kFixSpec = 1;")], None),
    "two boxes before the length": ([("constexpr int kFixSpec = 0;",
                                      "constexpr int kFixSpec = 2;")], None),
    "FFMA for 16-bit q": ([(
        "return launch_fixed<T, KV, D, (sizeof(T) == 2)>(",
        "return launch_fixed<T, KV, D, false>(")], None),
    # a cluster rank a split of the plan, 4 warps a rank (16 KB rings)
    "4 warps, a rank a split": ([
        ("constexpr int kFixWarps = 8;", "constexpr int kFixWarps = 4;"),
        ("constexpr int kFixRing = 8 * 1024;",
         "constexpr int kFixRing = 16 * 1024;")], None),
    "rings of 16 KB": ([("constexpr int kFixRing = 8 * 1024;",
                         "constexpr int kFixRing = 16 * 1024;")], None),
    "fixed: loads only": ([FIXED_LOADS_ONLY], None),
    # every block returns at once (results wrong): the launch's own time
    "fixed: exits at once": ([(
        "  // each warp's ring barriers (one arrival: lane 0's, with the boxes'",
        "  if (blockIdx.x < 1024) return;\n"
        "  // each warp's ring barriers (one arrival: lane 0's, with the boxes'")],
        None),
    # the warps' records stay where they are (results wrong): the cost of
    # the cluster's exchange
    "fixed: no cluster sum": ([
        ("hopper::mbar_arrive_tx(comb, cs * W * nown * REC * 4);",
         "hopper::mbar_arrive_tx(comb, 0);"),
        ("    for (int i = lane; i < qpk * Q4; i += 32) {",
         "    for (int i = lane; i < 0; i += 32) {")], None),
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
    rows (phase 2's own serving-layer calls, chip_smoke.py's K6_WIDE), then
    phase 3's and phase 11's decode calls."""
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
    d = cs.DIM // cs.HEADS
    pool = torch.randn((cs.BLOCKS * cs.TOTAL_PAGES, 2, cs.PAGE,
                        cs.KV_HEADS * d), generator=gen,
                       device=dev).to(torch.bfloat16)
    q = torch.randn((b, cs.HEADS, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    new = tuple(torch.randn((b, cs.KV_HEADS * d), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
    last = [(cs.BLOCKS - 1) * cs.TOTAL_PAGES]
    out["phase 2 bf16"] = (q, pool, cs.KV_HEADS, new, table, lengths, last)
    out["phase 2 e4m3"] = (q, pool.to(torch.float8_e4m3fn), cs.KV_HEADS, new,
                           table, lengths, last)
    for name, h, hkv, d, qdt, pdt in cs.K6_WIDE:
        if name not in CASES:
            continue
        pool = torch.randn((cs.TOTAL_PAGES, 2, cs.PAGE, hkv * d),
                           generator=gen, device=dev).to(pdt)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(qdt)
        new = tuple(torch.randn((b, hkv * d), generator=gen,
                                device=dev).to(qdt) for _ in range(2))
        out[name] = (q, pool, hkv, new, table, lengths, [0])
    # phase 3's decode call (4 tables x 12 layers in turns) and phase 11's
    # (the layers in turns)
    out["serving decode"] = cs.serving_decode_call(
        gen, np.random.RandomState(7), torch.bfloat16, b)
    out["serving decode e4m3"] = cs.serving_decode_call(
        gen, np.random.RandomState(7), torch.float8_e4m3fn, b)
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
        for kernel in ("paged_attention_fixed", "paged_attention_any"):
            for line in kernel_variants.spills(logs[name], kernel):
                print(f"  {name}: {kernel} {line}", flush=True)
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
                    tab, off = cs.decode_turn(i, table, offsets)
                    return PA.paged_attention(
                        q, pool, None, tab, lengths, num_kv_heads=hkv,
                        append_kv=new, page_offset=off)

                if rnd == 0:
                    acc = torch.promote_types(q.dtype, torch.float32)
                    tab, off = cs.decode_turn(0, table, offsets)
                    # the call's layer alone (a 26-layer pool in f32
                    # would take 16 GB)
                    layer = pool[off:off + cs.TOTAL_PAGES]
                    ref = PA.paged_attention_reference(
                        q.to(acc), layer if pool.element_size() == 1 else
                        layer.to(acc), None, tab, lengths, num_kv_heads=hkv,
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
    print(f"{'variant':26} " + " ".join(f"{c[:16]:>16}" for c in cases) +
          " host (decode)", flush=True)
    for name in chosen:
        row = " ".join(f"{np.median(times[name][c]):16.2f}" for c in cases)
        row += f" {np.median(host[name]):13.2f}"
        print(f"{name:26} {row}  (us a call; results "
              f"{'right' if right[name] else 'WRONG'})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
