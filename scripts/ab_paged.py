"""A/B timing of the paged-attention kernels (K6) between two checkouts of
the port, on one CUDA card, in turns.

    git archive <commit> lamp_tpu_torch | tar -x -C <dir>
    python3 scripts/ab_paged.py <dir> [rounds] [cases|call|decode]

The two checkouts' packages share a name, so each measurement runs in a
process of its own that imports one tree's lamp_tpu_torch: both trees'
kernels first build at once (each into its own _build/), then every round
measures the other tree, this tree, this tree and the other tree again.

"cases": phase 2's own calls (the serving slice's layer, 12 / 4 heads of
64, bf16 q over the 12-layer bf16 pool and over the same values in e4m3,
the last layer's page_offset) and each of chip_smoke.py's K6_WIDE cases at
phase 2's shapes (B=32, 4 pages of 128 tokens a sequence, lengths 0, 1,
127-129, 255, 511 and random, a pool of 192 pages) on the decode's own
call (append_kv, no window), through the tree's own ``paged_attention``
(its wrapper, its plan): the device time a call by CUDA events over the
replay of a CUDA graph of 100 back-to-back calls (median of 5 replays),
and the profiler's sum of the call's kernels over 20 eager calls beside
it. "call": phase 3's decode call (chip_smoke.py's serving_decode_call:
lengths of 56-95, the calls taking 4 page tables x 12 layers in turns,
cold) on the bf16 and e4m3 pools, and phase 11's (openllama_decode_call:
lengths of 56-95, the calls taking the 26 layers' pages in turns, as a
step does) timed so, and the host's time a call of phase 11's wrapper and
of its C entry point alone (chip_smoke.py's host_us: bursts of 10 calls on
a drained card; and 200 calls queued at once behind a sleeping kernel).
"decode": chip_smoke.py phase 3's steady decode (the serving slice's
ModernLM, 12 x 768, 12 / 4 heads of 64) and phase 11's, OpenLLaMA-3B (26
x 3200, 32 / 32 heads of 100), bf16, random weights from seed 0, each
behind ModernBatchServer(page_size=128, total_pages=192) with 32
requests: step_many(8) by CUDA events, then one profiled step_many(8):
the device's busy time a decode step and K6's part of it. All three
groups run by default.
Prints each measurement, the median of each side and the ratio of this
tree's to the other's.
"""

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def smoke():
    """This tree's chip_smoke.py (its constants and timers; it imports the
    package only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def worker(tree: str, build_only: bool, groups) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lamp_tpu_torch.ops import _build
    PA = importlib.import_module("lamp_tpu_torch.ops.paged_attention")

    assert Path(PA.__file__).resolve().is_relative_to(Path(tree).resolve())
    _build.build()
    if build_only:
        return
    _build.library()
    cs = smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    times = {}

    def prof_us(fn, calls=20):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.self_device_time_total > 0) / calls

    if "cases" in groups:
        gen = torch.Generator(device=dev).manual_seed(0)
        rng = np.random.RandomState(0)
        b, pps = 32, cs.CTX // cs.PAGE
        table = torch.as_tensor(np.stack([
            rng.choice(np.arange(1, cs.TOTAL_PAGES), pps, replace=False)
            for _ in range(b)]).astype(np.int32), device=dev)
        edge = [0, 1, 127, 128, 129, 255, 511]
        lengths = torch.as_tensor(np.asarray(
            edge + list(rng.randint(0, pps * cs.PAGE, b - len(edge))),
            np.int32), device=dev)
        # phase 2's own calls: the serving layer over the 12-layer pool
        d = cs.DIM // cs.HEADS
        pool = torch.randn((cs.BLOCKS * cs.TOTAL_PAGES, 2, cs.PAGE,
                            cs.KV_HEADS * d), generator=gen,
                           device=dev).to(torch.bfloat16)
        q = torch.randn((b, cs.HEADS, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        new = tuple(torch.randn((b, cs.KV_HEADS * d), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
        offset = (cs.BLOCKS - 1) * cs.TOTAL_PAGES
        for name, kv in (("phase 2 bf16", pool),
                         ("phase 2 e4m3", pool.to(torch.float8_e4m3fn))):
            def call(i=0, kv=kv):
                PA.paged_attention(q, kv, None, table, lengths,
                                   num_kv_heads=cs.KV_HEADS, append_kv=new,
                                   page_offset=offset)

            times[name] = cs.graph_ms(call) * 1e3
            times[f"{name} (profiler)"] = prof_us(call)
        del pool, kv
        for name, h, hkv, d, qdt, pdt in cs.K6_WIDE:
            pool = torch.randn((cs.TOTAL_PAGES, 2, cs.PAGE, hkv * d),
                               generator=gen, device=dev).to(pdt)
            q = torch.randn((b, h, d), generator=gen, device=dev).to(qdt)
            new = tuple(torch.randn((b, hkv * d), generator=gen,
                                    device=dev).to(qdt) for _ in range(2))

            def call(i=0):
                PA.paged_attention(q, pool, None, table, lengths,
                                   num_kv_heads=hkv, append_kv=new)

            times[name] = cs.graph_ms(call) * 1e3
            times[f"{name} (profiler)"] = prof_us(call)
            del pool
    if "call" in groups:
        # phase 3's decode call, 4 tables x 12 layers in turns (cold)
        gen = torch.Generator(device=dev).manual_seed(0)
        for name, pdt in (("serving decode", torch.bfloat16),
                          ("serving decode e4m3", torch.float8_e4m3fn)):
            rng = np.random.RandomState(7)
            q, pool, hkv, new, tables, lengths, offsets = \
                cs.serving_decode_call(gen, rng, pdt)

            def call(i=0):
                tab, off = cs.decode_turn(i, tables, offsets)
                PA.paged_attention(q, pool, None, tab, lengths,
                                   num_kv_heads=hkv, append_kv=new,
                                   page_offset=off)

            times[name] = cs.graph_ms(call) * 1e3
            times[f"{name} (profiler)"] = prof_us(call, 48)
            del pool
        # phase 11's decode call, the layers in turns as a step takes them
        rng = np.random.RandomState(0)
        q, pool, hkv, new, table, lengths, offsets = \
            cs.openllama_decode_call(gen, rng)

        def call(i=0):
            PA.paged_attention(q, pool, None, table, lengths,
                               num_kv_heads=hkv, append_kv=new,
                               page_offset=offsets[i % len(offsets)])

        times["openllama decode"] = cs.graph_ms(call) * 1e3
        times["openllama decode (profiler)"] = prof_us(call, len(offsets))
        # the host's time a call: the wrapper, then its C entry point alone
        # with the arguments the wrapper passes (an older entry that takes
        # no plan is passed none)
        times["openllama decode host us a call"] = cs.host_us(call)
        times["openllama decode host us a call, 200 queued"] = cs.host_us(
            call, queued=True)
        b, h, d = q.shape
        fn = _build.library().lamp_paged_attention
        # the entry's arguments by its arity: 22 (no plan), 24 (the plan),
        # 25 (the plan and the pool's pages)
        plan = PA._paged_plan(
            b, hkv, h // hkv, d, table.shape[1],
            torch.cuda.get_device_properties(dev).multi_processor_count) \
            if len(fn.argtypes) >= 24 else ()
        pages = (pool.shape[0],) if len(fn.argtypes) == 25 else ()
        out = torch.empty_like(q)
        page, fused = pool.shape[2], pool.shape[3]
        args = (q.data_ptr(), pool.data_ptr(),
                pool.data_ptr() + page * fused * pool.element_size(),
                new[0].data_ptr(), new[1].data_ptr(), table.data_ptr(),
                lengths.data_ptr(), None, out.data_ptr(), b, h, hkv, d, page,
                table.shape[1], *pages, 2 * page * fused, 0, 0, d ** -0.5, 1,
                1, *plan, torch.cuda.current_stream().cuda_stream)
        times["openllama decode host us a call, C entry"] = cs.host_us(
            lambda i: fn(*args))
        del pool
    if "decode" in groups:
        from lamp_tpu_torch import models
        from lamp_tpu_torch import nn as torch_nn

        # phase 3's serving model, then phase 11's OpenLLaMA-3B
        for label, make in (
                ("serving", lambda gen: cs.make_serving_model(torch_nn)),
                ("openllama", lambda gen: torch_nn.ModernLM.init(
                    vocab_size=cs.VOCAB, context_length=cs.OL_CTX,
                    num_blocks=cs.OL_BLOCKS, embed_dim=cs.OL_DIM,
                    num_heads=cs.OL_HEADS, num_kv_heads=cs.OL_HEADS,
                    mlp_hidden=cs.OL_MLP, tied=False, rope_base=10000.0,
                    norm_eps=1e-6, generator=gen, dtype=torch.bfloat16,
                    device=dev))):
            gen = torch.Generator(device=dev).manual_seed(0)
            model = make(gen)
            server = models.ModernBatchServer(model, page_size=cs.PAGE,
                                              total_pages=cs.TOTAL_PAGES)
            rng = np.random.RandomState(0)
            for i in range(32):
                server.add(f"s{i}",
                           rng.randint(0, cs.VOCAB, 24 + i % 8).tolist(),
                           models.SamplingParams(temperature=0.8))
            server.step_many(8)
            server.step_many(8)
            times[f"{label} decode step_many(8) by events, ms"] = \
                cs.cuda_time_ms(lambda: server.step_many(8), 3, warmup=0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                server.step_many(8)
                torch.cuda.synchronize()
            busy = k6 = 0.0
            for e in prof.key_averages():
                busy += e.self_device_time_total
                if "paged_attention" in e.key:
                    k6 += e.self_device_time_total
            times[f"{label} decode device us a step"] = busy / 8
            times[f"{label} decode K6 us a step"] = k6 / 8
            times[f"{label} decode K6 share"] = k6 / busy
            del server, model
            torch.cuda.empty_cache()
    print("AB " + json.dumps(times), flush=True)


def run(tree: str, groups, build_only: bool = False):
    cmd = [sys.executable, __file__, "--worker", tree, ",".join(groups)] + (
        ["--build"] if build_only else [])
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def main() -> int:
    other = str(Path(sys.argv[1]).resolve())
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    groups = sys.argv[3:4] or ["cases", "call", "decode"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    builds = [run(t, groups, build_only=True) for t in (other, str(ROOT))]
    for proc in builds:
        proc.communicate()
        if proc.returncode:
            raise SystemExit("a build failed")
    seen = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            proc = run(other if side == "other" else str(ROOT), groups)
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"the {side} tree's worker failed")
            line = next(x for x in out.splitlines() if x.startswith("AB "))
            seen[side].append(json.loads(line[3:]))
            print(side, line[3:], flush=True)
    for key in seen["this"][0]:
        a = statistics.median(m[key] for m in seen["other"])
        b = statistics.median(m[key] for m in seen["this"])
        print(f"{key:44} other {a:9.2f}, this {b:9.2f}, this / other "
              f"{b / a if a else float('nan'):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2], "--build" in sys.argv, sys.argv[3].split(","))
        sys.exit(0)
    sys.exit(main())
