"""The port's serving examples on the CPU, and what the port may import.

``examples/serving_demo_torch.py`` runs at tiny widths (1 block, 32 wide,
2 heads, context 64) with ``--device cpu``, from random weights and from
a loop state that the port's ``io.save_loop_state`` wrote;
``examples/openai_server_torch.py`` starts on port 0, answers one
completion and shuts down. A scan of the port's sources (the package, the
``examples/*_torch.py`` and the card's scripts) holds that none of them
imports ``jax``, ``lamp_tpu``, ``regex``, ``transformers`` or
``tokenizers``: the card's machine has none of them.
"""

import ast
import importlib.util
import json
import urllib.request
from pathlib import Path

import pytest
import torch

from lamp_tpu_torch import io as tio
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch import optim as toptim

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--layers", "1", "--dim", "32", "--heads", "2",
        "--context", "64"]
FORBIDDEN = {"jax", "jaxlib", "lamp_tpu", "regex", "transformers",
             "tokenizers"}


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("checkpoint", [False, True],
                         ids=["random", "checkpoint"])
def test_serving_demo_runs_on_cpu(checkpoint, tmp_path, capsys):
    demo = _example("serving_demo_torch")
    argv = TINY + ["--tokens", "6", "--prompts", "the quick ",
                   "the quick brown fox jumps over the lazy dog and ",
                   "in the beginning "]
    saved = None
    if checkpoint:
        model = tnn.LanguageModelModule.init(
            vocab_size=256, context_length=64, num_blocks=1, embed_dim=32,
            attention_heads=2, generator=torch.Generator().manual_seed(5),
            device="cpu")
        opt = toptim.AdamW(model.named_parameters(), 1e-3)
        path = str(tmp_path / "ck")
        tio.save_loop_state(path, model=model, optimizer_state=opt, epoch=1)
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        argv += ["--checkpoint", path]
    out = demo.main(argv)
    printed = capsys.readouterr().out
    assert ("loaded checkpoint" in printed) == checkpoint
    results, server = out["results"], out["server"]
    # staggered budgets: 6, 16 and 26 tokens
    assert [len(results[f"req{i}"]) for i in range(3)] == [6, 16, 26]
    assert out["tokens"] == 48
    assert server.enable_prefix_cache and not server.seq_pages
    # no prompt fills a 32-token page, so nothing can hit; every prompt
    # token but the last is prefilled
    assert server.cache_hit_tokens == 0
    assert server.cache_miss_tokens == 9 + 47 + 16
    assert "prefix cache hit/miss tokens 0/72" in printed
    if checkpoint:
        for k, v in server.model.state_dict().items():
            assert torch.equal(v, saved[k]), k


def test_openai_server_example_serves_a_completion():
    example = _example("openai_server_torch")
    api = example.serve(TINY + ["--port", "0", "--page-size", "8",
                                "--total-pages", "32"])
    try:
        assert api.port > 0
        req = urllib.request.Request(
            f"http://127.0.0.1:{api.port}/v1/completions",
            data=json.dumps({"prompt": "hello", "temperature": 0.0,
                             "max_tokens": 5}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            resp = json.loads(r.read())
    finally:
        api.shutdown()
    assert resp["model"] == "lamp-byte-lm"
    assert resp["usage"] == {"prompt_tokens": 5, "completion_tokens": 5,
                             "total_tokens": 10}
    assert resp["choices"][0]["finish_reason"] == "length"


def _port_sources():
    # the package's sources, not what a build put under its _build/
    yield from sorted(p for p in (ROOT / "lamp_tpu_torch").rglob("*.py")
                      if "_build" not in p.relative_to(ROOT).parts)
    yield from sorted((ROOT / "examples").glob("*_torch.py"))
    yield ROOT / "chip_smoke.py"
    yield ROOT / "scripts" / "chip_phases.py"


def test_port_imports_no_jax_regex_or_hf_libraries():
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found, found
