"""Experiment: the stochastic int8 quantizer (K8) against edited copies of
itself and against another checkout's source of it, on one CUDA card, at
chip_smoke.py's K8_SHAPES in bf16.

    python3 scripts/exp_quant8_variants.py [rounds] [--parent FILE]

Variants of ``csrc/quantize_int8.cu`` (scripts/kernel_variants.py builds
each beside this tree's other sources), each a knock-out of one part of the
design or a part put back as it was:

- "as built";
- "three hashes": each element's word from its 64-bit flat index, three
  lowbias32 hashes (the key no longer taken once a row);
- "fdiv": the IEEE division an element (``__fdiv_rn``) for the quotient;
- "conversions": floorf, the u of an I2F and the (int) of an F2I, as
  before (FRND, I2F, F2I an element);
- "u from the bits": no conversion at all: u as the word's top 23 bits in
  the significand of a float in [1, 2), less 1, plus bit 8 as 2^-24
  ((word & 0x100) 0x338000 is the pattern of 2^-24), for the I2F;
- "compare by FSETP": u < frac by a compare and a select, for the sign
  bit of u - frac;
- "row read twice": the output pass re-reads each 16-byte chunk from L2
  (``__ldcg``) instead of the registers that the absmax pass filled;
- "absmax unpacked": the absmax of floats, two instructions an element,
  for the packed bf16 pairs' one;
- "clip": the quotient clipped to 127 (two instructions an element), for
  leaving the clip to the redo;
- "no redo": the redo's check taken out (the same bytes wherever no
  element has |u - frac| <= 2^-17 and a quotient under 2^-64 or past 127,
  as almost everywhere);
- "12 chunks at every width": every row of up to 3072 bf16 held by the
  instance of 12 chunks a lane, for the fewest chunks that hold it (3 at
  768 columns: fewer registers);
- knock-outs that change the result, to weigh a part: "no hash" (the word
  is the index's low bits xor the key), "no rounding" (the byte is the
  quotient's low bits), "memory only" (both);
- "parent", where ``--parent`` names another checkout's
  ``csrc/quantize_int8.cu`` (same C signature): built the same way.

Every case is timed by CUDA events over the replay of a CUDA graph of 100
calls (chip_smoke.graph_ms), in turns over ``rounds`` rounds (default 5),
and once by the profiler's device time (chip_smoke.device_ms); each prints
its median, ptxas's registers, and whether its values and scales equal the
as-built kernel's bit for bit. Last, the per-element instruction mix of the
bf16 vector instance: ``cuobjdump -sass`` of it at 12 chunks a lane less
the same at 11 (the difference is one chunk of 8 elements, unrolled),
divided by 8, both with the redo (a branch run for one chunk in 2^12)
taken out.
"""

import collections
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import kernel_variants  # noqa: E402
from lamp_tpu_torch.ops import _build  # noqa: E402

OUT = ROOT / "lamp_tpu_torch" / "_build" / "variants_q8"
SOURCE = "quantize_int8.cu"
_WORD = "round_byte(q, word_u(h, static_cast<uint32_t>(e)), below)"
_BYTE_BODY = (
    "  const float t = __fadd_rd(s, kMagic);  // 1.5 2^23 + floor(s)\n"
    "  const float frac = __fsub_rn(s, __fsub_rn(t, kMagic));\n"
    "  below = __fmaf_rn(__uint2float_rn(wu), 0x1p-32f, -frac);\n"
    "  return __float_as_uint(t) + (__float_as_uint(below) >> 31);\n")
_BELOW = "  below = __fmaf_rn(__uint2float_rn(wu), 0x1p-32f, -frac);\n"
_REDO = "    if (redo) {"
_SIGN = "  return __float_as_uint(t) + (__float_as_uint(below) >> 31);\n"
_NO_HASH = "round_byte(q, (h ^ static_cast<uint32_t>(e)) & ~0xFFu, below)"
VARIANTS = {
    "as built": [],
    "three hashes": [(_WORD, (
        "round_byte(q, lowbias32(static_cast<uint32_t>(off + c + e) ^ lowbias32(seed ^ "
        "lowbias32(static_cast<uint32_t>(static_cast<unsigned long long>(off + c + e) "
        ">> 32)))) & ~0xFFu, below)"))],
    "fdiv": [("const float q = sizeof(T) == 2 ? quotient(p[e], scale, inv) : "
              "__fdiv_rn(p[e], scale);",
              "const float q = __fdiv_rn(p[e], scale);")],
    "conversions": [(_BYTE_BODY, (
        "  const float f = floorf(s);\n"
        "  const float u = (float)(wu >> 8) * (1.0f / 16777216.0f);\n"
        "  below = u - (s - f);\n"
        "  return (uint32_t)(int)(f + (u < s - f ? 1.f : 0.f));\n"))],
    "u from the bits": [(_BELOW, (
        "  const float u = (__uint_as_float(0x3F800000u | (wu >> 9)) - 1.0f) +\n"
        "                  __uint_as_float((wu & 0x100u) * 0x338000u);\n"
        "  below = __fsub_rn(u, frac);\n"))],
    "compare by FSETP": [(_SIGN, (
        "  return __float_as_uint(t) + (__uint2float_rn(wu) * 0x1p-32f < frac"
        " ? 1u : 0u);\n"))],
    "row read twice": [("      if (c < k) quantize(xv[j], c);\n", (
        "      if (c < k) {\n"
        "        Pack<T, V> p;\n"
        "        const uint4 a = __ldcg(reinterpret_cast<const uint4*>(xr + c));\n"
        "        p.r[0] = a.x, p.r[1] = a.y, p.r[2] = a.z, p.r[3] = a.w;\n"
        "        quantize(p, c);\n"
        "      }\n"))],
    "absmax unpacked": [("    if constexpr (sizeof(T) == 2 && V > 1) {\n#pragma unroll\n"
                         "      for (int i = 0; i < 4; ++i) {",
                         "    if constexpr (false) {\n#pragma unroll\n"
                         "      for (int i = 0; i < 4; ++i) {"),
                        ("    if constexpr (sizeof(T) == 2 && V > 1) return fmaxf(",
                         "    if constexpr (false) return fmaxf(")],
    "clip": [("round_byte(q, word_u(", "round_byte(fminf(fmaxf(q, -127.f), 127.f), word_u(")],
    "no redo": [("      redo |= fabsf(below) <= 0x1p-17f;\n", "")],
    "no hash": [(_WORD, _NO_HASH)],
    "no rounding": [(_BYTE_BODY, "  below = 1.0f;\n  return __float_as_uint(s) ^ wu;\n")],
    "memory only": [(_WORD, _NO_HASH),
                    (_BYTE_BODY, "  below = 1.0f;\n  return __float_as_uint(s) ^ wu;\n")],
    "12 chunks at every width": [
        ("  if (k <= 32 * V * 3) return", "  if (false) return"),
        ("  if (k <= 32 * V * 6) return", "  if (false) return")],
    # for the instruction mix only: the redo taken out, at 12 chunks a lane
    # and at 11
    "mix 12": [(_REDO, "    if (false) {")],
    "mix 11": [(_REDO, "    if (false) {"),
               ("return launch<T, V, 12>(", "return launch<T, V, 11>(")],
}
TIMED = [v for v in VARIANTS if not v.startswith("mix")]


def call(lib, x, seed=1):
    m, k = x.shape
    vals = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rc = lib.lamp_quantize_int8_stochastic(
        x.data_ptr(), vals.data_ptr(), scales.data_ptr(), m, k, seed, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: {rc}")
    return vals, scales


def registers(log: str, kernel: str):
    """ptxas's 'Used N registers' of each bf16 vector instance of
    ``kernel`` in an nvcc log, by its chunks a lane (the parent's, of no
    chunk argument, as "-")."""
    lines, found = log.splitlines(), {}
    for j, line in enumerate(lines):
        if kernel in line and "Compiling entry" in line and \
                "__nv_bfloat16Li8E" in line:
            chunks = re.search(r"__nv_bfloat16Li8ELi(\d+)E", line)
            for nxt in lines[j + 1:j + 5]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    found[chunks.group(1) if chunks else "-"] = int(m.group(1))
                    break
    return found


def opcodes(so: Path, chunks: int):
    """Opcode counts of the bf16 vector instance with ``chunks`` chunks a
    lane, from cuobjdump -sass."""
    nvcc = Path(_build._nvcc())
    dump = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    want = f"quantize_int8_stochastic_kernelI13__nv_bfloat16Li8ELi{chunks}E"
    counts, keep = collections.Counter(), False
    for line in dump.splitlines():
        if "Function :" in line:
            keep = want in line
        elif keep:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         line)
            if m:
                counts[m.group(1)] += 1
    return counts


def main(rounds: int, parent) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    variants, names = dict(VARIANTS), list(TIMED)
    if parent:  # the whole source replaced by the other checkout's
        current = kernel_variants.SRC.joinpath(SOURCE).read_text()
        variants["parent"] = [(current, Path(parent).read_text())]
        names.append("parent")
    libs, logs = kernel_variants.build(SOURCE, variants, OUT)
    for name in names:
        print(f"  {name}: {registers(logs[name], 'quantize_int8')} registers",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k in chip_smoke.K8_SHAPES:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        ref = call(libs["as built"], x)
        times = {name: [] for name in names}
        for _ in range(rounds):
            for name in names:
                times[name].append(chip_smoke.graph_ms(
                    lambda i, lib=libs[name]: call(lib, x, i)))
        bound = (m * k * 3 + m * 4) / chip_smoke.PEAK_BYTES * 1e3
        print(f"[{m}, {k}] bf16 (medians of {rounds} rounds by graph, us a "
              f"call; bound {bound * 1e3:.2f} us by bytes):", flush=True)
        for name in names:
            prof = chip_smoke.device_ms(lambda: call(libs[name], x), 50)
            got = call(libs[name], x)
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            print(f"  {name:18} {np.median(times[name]) * 1e3:8.2f} (min "
                  f"{min(times[name]) * 1e3:.2f}); profiler "
                  f"{sum(prof.values()) * 1e3:.2f}; bits as built: {same}",
                  flush=True)
    full = opcodes(OUT / f"v{list(variants).index('mix 12')}.so", 12)
    less = opcodes(OUT / f"v{list(variants).index('mix 11')}.so", 11)
    mix = {op: (full[op] - less[op]) / 8 for op in full
           if full[op] != less[op]}
    print("instruction mix an element, bf16 vector instance (one chunk of 8 "
          "unrolled, without the redo): "
          + ", ".join(f"{op} {n:g}" for op, n in
                      sorted(mix.items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"  total {sum(mix.values()):g} an element; conversions I2F "
          f"{mix.get('I2F', 0):g}, F2I {mix.get('F2I', 0):g}, FRND "
          f"{mix.get('FRND', 0):g}, MUFU {mix.get('MUFU', 0):g}", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = args[i + 1]
        del args[i:i + 2]
    sys.exit(main(int(args[0]) if args else 5, parent))
