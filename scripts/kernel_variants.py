"""Edited copies of one kernel source, built beside each other: the build
shared by scripts/exp_k1_variants.py, exp_k2_variants.py,
exp_any_variants.py, exp_fwd_any_variants.py, exp_wide_variants.py and
exp_int4_variants.py.

A variant is a list of (text, replacement) edits of the source; every
occurrence of an edit's text is replaced. The package's other sources
(every other ``csrc/*.cu``) compile once, the variants at the same time
(one nvcc each, with the package's flags), and each variant links with
them into a library of its own, loaded through ctypes with the package's
C signatures (``_build.load``), so that several load side by side.
"""

import subprocess
from pathlib import Path

from lamp_tpu_torch.ops import _build

SRC = _build._SRC_DIR


def build(source: str, variants: dict, out: Path, text: str = None):
    """Build ``variants`` ({name: edits}) of ``csrc/<source>`` into ``out``;
    returns ({name: loaded library}, {variant name or source file name:
    nvcc's output}). ``text``, when given, is the source to edit in place
    of this tree's ``csrc/<source>`` (another checkout's copy of it, whose
    headers must be this tree's). Exits if an edit's text is missing or a
    file does not build."""
    out.mkdir(parents=True, exist_ok=True)
    text = (SRC / source).read_text() if text is None else text
    others = sorted(p for p in SRC.glob("*.cu") if p.name != source)
    jobs = {p.name: (p, out / f"{p.stem}.o") for p in others}
    for i, (name, edits) in enumerate(variants.items()):
        edited = text
        for old, new in edits:
            if old not in edited:
                raise SystemExit(f"variant {name!r}: {old!r} not in {source}")
            edited = edited.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(edited)
        jobs[name] = (cu, out / f"v{i}.o")
    nvcc = _build._nvcc()
    procs = {key: subprocess.Popen(
        [nvcc, *_build._FLAGS, f"-I{SRC}", "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (src, obj) in jobs.items()}
    logs = {}
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{key!r} did not build:\n{logs[key][-4000:]}")
    shared = [str(jobs[p.name][1]) for p in others]
    libs = {}
    for name in variants:
        obj = jobs[name][1]
        so = obj.with_suffix(".so")
        subprocess.run([nvcc, "-shared", "-o", str(so), str(obj), *shared],
                       check=True)
        libs[name] = _build.load(so)
    return libs, logs


def spills(log: str, kernel: str):
    """ptxas's stack-frame lines, from ``-Xptxas -v`` output, of the
    kernels whose mangled name holds ``kernel`` and that have a stack
    frame or spills."""
    lines = log.splitlines()
    return [f"{lines[j - 1].split(kernel)[-1][:24]}: {line.strip()}"
            for j, line in enumerate(lines) if "spill stores" in line
            and kernel in lines[j - 1]
            and not line.strip().startswith("0 bytes stack frame, 0")]
