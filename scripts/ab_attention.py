"""A/B timing of the attention kernels between two checkouts of the port,
on one CUDA card, in turns.

    git archive <commit> lamp_tpu_torch | tar -x -C <dir>
    python3 scripts/ab_attention.py <dir> [rounds] [tc|any|ragged]

The two checkouts' packages share a name, so each measurement runs in a
process of its own that imports one tree's lamp_tpu_torch: both trees'
kernels first build at once (each into its own _build/), then every round
measures the other tree, this tree, this tree and the other tree again.
Each measurement is the device time a call (torch.profiler, the mean over
30 calls, held against CUDA events of the same calls: a trace that sums to
less than 0.8 of the events' time is taken again, up to twice, and both
figures are printed) of the forward's kernels (whichever instance runs: fwd_tc before
the wgmma forward, fwd_wg since; with segment ids, tile_classes too) at
the training slice's B=2, H=12, S=4096, the flagship's B=8, H=12, S=384,
chip_smoke.py phase 10's packed shapes (B=4, H=12, S=2048, segment ids)
and B=2, H=8, S=2048 at head dims 160, 192 and 256 (bf16, causal), of
scaled_dot_product_attention at the same shapes (the same call in both
trees: a yardstick measured on the same card; with the equivalent
boolean attn_mask at the packed shapes), of the dq (dq_tc) and dkv
(dkv_tc) kernels at S=4096 and S=384, of the 16-bit backward above head
dim 128 (dq_mma and dkv_mma before, dq_wide and dkv_wide since) at B=2,
H=8, S=2048, D=160, 192 and 256 beside SDPA's backward there (each tree's
largest block error against the plain backward in f32 is printed: the
trees sum in different orders, so they are not hashed against each
other), and of the paged-attention kernel
at chip_smoke.py phase 2's shape (B=32, 12/4 heads, head_dim 64, the
12-layer bf16 pool, append): the "tc" group. The "any" group times the
kernels for the inputs the tensor-core kernels do not take, at B=2, H=8,
S=2048, causal, in float64 at head dims 64 and 100, float32 at 64 and 100
and bfloat16 at 320, and at the f32 flagship's B=8, H=12, S=384, D=64:
the forward (fwd_any) beside SDPA's forward, and the backward (dq_any and
dkv_any) beside SDPA's backward (the autograd backward of
scaled_dot_product_attention, dq, dk and dv), at the same shape and
dtype. It also hashes dq, dk and dv of the backward kernels on the plain
forward's o and lse, which both trees compute alike, and prints whether
the two trees' backward agree bit for bit. The "ragged" group times the
16-bit head dims that are not multiples of 8 at B=2, H=8, S=2048, causal,
bf16, D=12, 75, 100, 130 and 250: the forward (fwd_tc on mma.sync in
older trees, fwd_wg with a cp.async producer now) beside SDPA's forward,
and the backward's dq and dkv kernels and their sum (dq_mma and dkv_mma in
older trees, the wgmma kernels with a cp.async producer now) beside
SDPA's backward; it prints each tree's block error of o, dq, dk and dv against
the plain version in f32, checks that two backward calls of each tree
give the same bits, and hashes the TMA instances' outputs (fwd_wg, dq_tc,
dkv_tc, dq_wide, dkv_wide at D=64, 128, 192 and 256, unmasked and with
segment ids) on the plain forward's o and lse, which the two trees must
give bit for bit. A third argument names one group; "tc" and "any" run by
default. Prints each measurement and the median of
each side, and the ratio of this tree's to the other's.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CALLS = 30


# the "ragged" group's head dims (bf16, B=2, H=8, S=2048, causal)
RAGGED_DIMS = (12, 75, 100, 130, 250)
# the ragged group's hashed TMA instances: (head dim, segment ids)
TMA_BITS = ((64, False), (128, False), (192, False), (256, False),
            (64, True), (256, True))
# the "any" group's shapes: (dtype name, head dim, B, H, S)
ANY_SHAPES = (("float64", 64, 2, 8, 2048), ("float64", 100, 2, 8, 2048),
              ("float32", 64, 2, 8, 2048), ("float32", 100, 2, 8, 2048),
              ("bfloat16", 320, 2, 8, 2048), ("float32", 64, 8, 12, 384))


def worker(tree: str, build_only: bool, groups) -> None:
    sys.path.insert(0, tree)
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from lamp_tpu_torch.ops import _build
    from lamp_tpu_torch.ops import attention as att
    from lamp_tpu_torch.ops.paged_attention import paged_attention

    assert Path(att.__file__).resolve().is_relative_to(Path(tree).resolve())
    _build.build()
    if build_only:
        return
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    checks = {}  # label: [profiler's sum, CUDA events] a call, us

    def per_launch(fn, names, label):
        """Device time a call (us) of the kernels whose names hold one of
        ``names``, by name; every kernel's summed under "all". The same
        calls are timed by CUDA events: a trace whose kernels sum to less
        than 0.8 of the events' time lost records and is taken again, up to
        twice; ``checks[label]`` keeps both figures."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                start.record()
                for _ in range(CALLS):
                    fn()
                end.record()
                torch.cuda.synchronize()
            out = {"all": 0.0}
            for e in prof.key_averages():
                if not e.self_device_time_total:
                    continue
                out["all"] += e.self_device_time_total / CALLS
                for name in names:
                    if name in e.key:
                        out[name] = out.get(name, 0.0) + \
                            e.self_device_time_total / CALLS
            events = start.elapsed_time(end) * 1e3 / CALLS
            checks[label] = [out["all"], events]
            if out["all"] >= 0.8 * events:
                break
        return out

    def block_err(got, want):
        """The largest relative Frobenius error over 64-row blocks of each
        (b, h) slab (chip_smoke.py's block_err)."""
        pad = -want.shape[2] % 64
        g, w = (torch.nn.functional.pad(x.double(), (0, 0, 0, pad)).reshape(
            x.shape[0], x.shape[1], -1, 64 * x.shape[3]) for x in (got, want))
        num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
        return float((num[den > 0] / den[den > 0]).max())

    times = {}
    errs = {}
    if "ragged" in groups:
        import hashlib

        def digest(tensors):
            return hashlib.sha256(b"".join(
                x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                for x in tensors)).hexdigest()[:16]

        bits = {}
        for d in RAGGED_DIMS:
            q, k, v, do = (randn(2, 8, 2048, d) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            times[f"fwd ragged D={d}"] = per_launch(
                lambda: att._fwd_cuda(q, k, v, None, True, scale, None),
                ["fwd_"], f"fwd ragged D={d}")["fwd_"]
            times[f"SDPA fwd ragged D={d}"] = per_launch(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                [], f"SDPA fwd ragged D={d}")["all"]
            o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
            bwd = per_launch(lambda: att._bwd_cuda(
                q, k, v, o, lse, do, None, True, scale, None),
                ["dq_", "dkv_"], f"bwd ragged D={d}")
            times[f"dq ragged D={d}"] = bwd["dq_"]
            times[f"dkv ragged D={d}"] = bwd["dkv_"]
            times[f"bwd ragged D={d}"] = bwd["dq_"] + bwd["dkv_"]
            ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            times[f"SDPA bwd ragged D={d}"] = per_launch(
                lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                            retain_graph=True), [],
                f"SDPA bwd ragged D={d}")["all"]
            first, second = (att._bwd_cuda(q, k, v, o, lse, do, None, True,
                                           scale, None) for _ in range(2))
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise SystemExit(f"ragged D={d}: two backward calls differ")
            f32 = [x.float() for x in (q, k, v, do)]
            want_o, want_lse = att.flash_attention_reference(
                *f32[:3], causal=True)
            wants = att._flash_backward_reference(
                *f32[:3], want_o, want_lse, f32[3], causal=True,
                sm_scale=scale)
            errs[f"fwd ragged D={d}"] = block_err(o, want_o)
            errs[f"bwd ragged D={d}"] = max(
                block_err(g, w) for g, w in zip(first, wants))
            del o, lse, lo, first, second, f32, want_o, want_lse, wants
        # the TMA instances on inputs both trees compute alike (the plain
        # forward's o and lse for the backward): the same bits in both
        for d, with_ids in TMA_BITS:
            q, k, v, do = (randn(2, 4, 1000, d) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            ids = None
            if with_ids:
                ids = torch.as_tensor(np.sort(np.random.RandomState(3).randint(
                    0, 4, (2, 1000)), 1).astype(np.int32), device=dev)
            vis = att._Visibility(q, ids, None)
            o, lse = att._fwd_cuda(q, k, v, None, True, scale, None, vis)
            po, plse = att.flash_attention_reference(
                q, k, v, causal=True, segment_ids=ids)
            grads = att._bwd_cuda(q, k, v, po, plse, do, None, True, scale,
                                  None, vis)
            what = f"TMA D={d}" + (" ids" if with_ids else "")
            bits[f"{what} fwd"] = digest((o, lse))
            bits[f"{what} bwd"] = digest(grads)
            del o, lse, po, plse, grads
        print("BITS " + json.dumps(bits), flush=True)
        if groups == ["ragged"]:
            print("ERR " + json.dumps(errs), flush=True)
            print("EV " + json.dumps(checks), flush=True)
            print("AB " + json.dumps(times), flush=True)
            return
    if "any" in groups:
        import hashlib

        bits = {}
        for name, d, b, h, s in ANY_SHAPES:
            dtype = getattr(torch, name)
            q, k, v, do = (randn(b, h, s, d, dtype=dtype) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            what = f"{name} D={d}" + ("" if (b, h, s) == (2, 8, 2048) else
                                      f" B={b} H={h} S={s}")
            times[f"fwd_any {what}"] = per_launch(lambda: att._fwd_cuda(
                q, k, v, None, True, scale, None), ["fwd_any"],
                f"fwd_any {what}")["fwd_any"]
            times[f"SDPA fwd {what}"] = per_launch(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
                [], f"SDPA fwd {what}")["all"]
            o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
            bwd = per_launch(lambda: att._bwd_cuda(
                q, k, v, o, lse, do, None, True, scale, None),
                ["dq_any", "dkv_any"], f"any bwd {what}")
            for kernel in ("dq_any", "dkv_any"):
                times[f"{kernel} {what}"] = bwd[kernel]
            times[f"any bwd {what}"] = bwd["dq_any"] + bwd["dkv_any"]
            ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            times[f"SDPA bwd {what}"] = per_launch(
                lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                            retain_graph=True), [],
                f"SDPA bwd {what}")["all"]
            # the backward's bits on inputs both trees compute alike
            po, plse = att.flash_attention_reference(q, k, v, causal=True)
            grads = att._bwd_cuda(q, k, v, po, plse, do, None, True, scale,
                                  None)
            bits[f"bwd {what}"] = hashlib.sha256(b"".join(
                g.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                for g in grads)).hexdigest()[:16]
            del po, plse, grads, lo
        print("BITS " + json.dumps(bits), flush=True)
        if "tc" not in groups:
            print("EV " + json.dumps(checks), flush=True)
            print("AB " + json.dumps(times), flush=True)
            return
    from lamp_tpu_torch.data import pack_documents

    rng = np.random.RandomState(0)  # chip_smoke.py's packed_batch
    docs = [rng.randint(0, 32000, rng.randint(64, 1025)) for _ in range(32)]
    packed = torch.as_tensor(pack_documents(docs, 2048)["segment_ids"][:4],
                             device=dev)
    # (name, B, H, S, head_dim, segment ids)
    for what, b, h, s, d, ids in (("S=4096", 2, 12, 4096, 64, None),
                                  ("S=384", 8, 12, 384, 64, None),
                                  ("packed", 4, 12, 2048, 64, packed),
                                  ("D=160", 2, 8, 2048, 160, None),
                                  ("D=192", 2, 8, 2048, 192, None),
                                  ("D=256", 2, 8, 2048, 256, None)):
        q, k, v, do = (randn(b, h, s, d) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        vis = att._Visibility(q, ids, None)
        fwd = per_launch(lambda: att._fwd_cuda(q, k, v, None, True, scale,
                                               None, vis), ["fwd_"],
                         f"fwd {what}")
        times[f"fwd {what}"] = fwd["all"]
        if ids is None:
            sdpa = dict(is_causal=True)
        else:
            sdpa = dict(attn_mask=att._visible(
                q, k, causal=True, window=None, kv_lengths=None,
                segment_ids=ids, mask=None))
        times[f"SDPA fwd {what}"] = per_launch(
            lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), [],
            f"SDPA fwd {what}")["all"]
        if what in ("S=4096", "S=384"):
            o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
            bwd = per_launch(lambda: att._bwd_cuda(q, k, v, o, lse, do, None,
                                                   True, scale, None),
                             ["dq_tc", "dkv_tc"], f"bwd {what}")
            for name in ("dq_tc", "dkv_tc"):
                times[f"{name} {what}"] = bwd[name]
        if what.startswith("D="):
            # the 16-bit backward above 128 (dq_mma/dkv_mma before, dq_wide/
            # dkv_wide since), beside SDPA's backward, and each tree's
            # block error against the plain backward in f32
            o, lse = att._fwd_cuda(q, k, v, None, True, scale, None)
            bwd = per_launch(lambda: att._bwd_cuda(q, k, v, o, lse, do, None,
                                                   True, scale, None),
                             ["dq_", "dkv_"], f"bwd {what}")
            times[f"dq {what}"], times[f"dkv {what}"] = bwd["dq_"], bwd["dkv_"]
            times[f"bwd {what}"] = bwd["dq_"] + bwd["dkv_"]
            ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            times[f"SDPA bwd {what}"] = per_launch(
                lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                            retain_graph=True), [],
                f"SDPA bwd {what}")["all"]
            got = att._bwd_cuda(q, k, v, o, lse, do, None, True, scale, None)
            f32 = [x.float() for x in (q, k, v, o, do)]
            want = att._flash_backward_reference(
                *f32[:4], lse, f32[4], causal=True, sm_scale=scale)
            errs[f"bwd {what}"] = max(block_err(g, w)
                                      for g, w in zip(got, want))
            del o, lse, lo, got, want, f32
    # phase 2's shape: 12 layers x 192 pages of 128 tokens, 4 kv heads of 64
    rng = np.random.RandomState(0)
    pool = randn(12 * 192, 2, 128, 256)
    qp, nk, nv = randn(32, 12, 64), randn(32, 256), randn(32, 256)
    table = torch.as_tensor(np.stack([rng.choice(np.arange(1, 192), 4,
                                                 replace=False)
                                      for _ in range(32)]).astype(np.int32),
                            device=dev)
    edge = [0, 1, 127, 128, 129, 255, 511]
    lengths = torch.as_tensor(np.asarray(
        edge + list(rng.randint(0, 512, 32 - len(edge))), np.int32),
        device=dev)
    k6 = per_launch(lambda: paged_attention(
        qp, pool, None, table, lengths, num_kv_heads=4, append_kv=(nk, nv),
        page_offset=11 * 192), ["paged_attention"], "paged_attention")
    times["paged_attention"] = k6["paged_attention"]
    print("ERR " + json.dumps(errs), flush=True)
    print("EV " + json.dumps(checks), flush=True)
    print("AB " + json.dumps(times), flush=True)


def run(tree: str, groups, build_only: bool = False):
    cmd = [sys.executable, __file__, "--worker", tree, ",".join(groups)] + (
        ["--build"] if build_only else [])
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def main() -> int:
    other = str(Path(sys.argv[1]).resolve())
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    groups = sys.argv[3:4] or ["tc", "any"]
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
    bits = {"other": [], "this": []}
    errs = {"other": [], "this": []}
    evs = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            proc = run(other if side == "other" else str(ROOT), groups)
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"the {side} tree's worker failed")
            line = next(x for x in out.splitlines() if x.startswith("AB "))
            seen[side].append(json.loads(line[3:]))
            print(side, line[3:], flush=True)
            for x in out.splitlines():
                if x.startswith("BITS "):
                    bits[side].append(json.loads(x[5:]))
                if x.startswith("ERR "):
                    errs[side].append(json.loads(x[4:]))
                if x.startswith("EV "):
                    evs[side].append(json.loads(x[3:]))
    for key in seen["this"][0]:
        a = statistics.median(m[key] for m in seen["other"])
        b = statistics.median(m[key] for m in seen["this"])
        print(f"{key:40} other {a:8.2f} us, this {b:8.2f} us, "
              f"this / other {b / a:.3f}", flush=True)
    # every reading against CUDA events of the same calls: the profiler's
    # sum of a call's kernels at 0.8 of the events' time or above passes
    for side, runs in evs.items():
        for label in runs[0]:
            prof = statistics.median(r[label][0] for r in runs)
            ev = statistics.median(r[label][1] for r in runs)
            low = sum(r[label][0] < 0.8 * r[label][1] for r in runs)
            print(f"{side:5} {label:36} profiler {prof:8.2f} us, CUDA events "
                  f"{ev:8.2f} us, ratio {prof / ev:.3f}" + (
                      f"; {low} of {len(runs)} readings below 0.8"
                      if low else ""), flush=True)
    if errs["this"]:
        # the trees sum in different orders here: each against the plain
        # version, not against each other
        for key in errs["this"][0]:
            print(f"{key}: largest block error against the plain version "
                  + ", ".join(f"{side} {max(m[key] for m in errs[side]):.3e}"
                              for side in ("other", "this")), flush=True)
    if bits["this"]:
        for key in bits["this"][0]:
            seen_bits = {m[key] for side in bits.values() for m in side}
            print(f"{key}: the two trees' outputs "
                  f"{'agree bit for bit' if len(seen_bits) == 1 else 'DIFFER'}"
                  f" ({', '.join(sorted(seen_bits))})", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2], "--build" in sys.argv, sys.argv[3].split(","))
        sys.exit(0)
    sys.exit(main())
