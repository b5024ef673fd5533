"""examples/autoregressivelm_torch.py, the port's LM example, in-process on
the CPU: ``train``, ``train --resume`` and ``generate`` at 1 block and
width 32, and its checkpoint file crossing with examples/autoregressivelm.py
(the JAX example) both ways.

The crossing runs in f32 (``--no-bf16``): the JAX package's greedy tokens
from ``models.generate`` on the checkpoint equal the port example's
``generate --temperature 0`` on the same file (the two forwards agree to
~1e-6 in f32).
"""

import importlib.util
import json
import os
import sys
from argparse import Namespace
from pathlib import Path

import jax
import numpy as np
import pytest

from lamp_tpu import io as jio
from lamp_tpu import models as jmodels
from lamp_tpu import optim as joptim
from lamp_tpu import train as jtrain

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--layers", "1", "--dim", "32", "--heads", "2", "--context", "16",
         "--no-bf16"]
TRAIN = ["--corpus", str(ROOT / "README.md"), "--batch-size", "2",
         "--grad-accum", "2"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port_example():
    return _example("autoregressivelm_torch")


def _jax_greedy(path, length=8, prompt=b"The "):
    """The JAX example's model, loaded from ``path``, decoding greedily."""
    example = _example("autoregressivelm")
    args = Namespace(vocab_size=256, context=16, layers=1, dim=32, heads=2,
                     dropout=0.0, bf16=False)
    model = example.build_model(args, jax.random.PRNGKey(0))
    state = jtrain.TrainState.init(model, joptim.AdamW(1e-3))
    loaded, _ = jio.load_loop_state(path, model_template=state.model,
                                    optimizer_state_template=state.opt_state)
    prompt = np.frombuffer(prompt, np.uint8).astype(np.int32)
    return jmodels.generate(loaded["model"], prompt[None, :], length,
                            temperature=0)


def test_train_resume_generate_on_cpu(port_example, tmp_path):
    ck = str(tmp_path / "ck")
    first = port_example.main(["train", *SMALL, *TRAIN, "--steps", "3",
                               "--device", "cpu", "--checkpoint", ck])
    assert first["start"] == 0 and len(first["losses"]) == 3
    assert all(np.isfinite(first["losses"]))
    with open(ck + ".meta") as f:
        assert json.load(f)["epoch"] == 3
    again = port_example.main(["train", *SMALL, *TRAIN, "--steps", "3",
                               "--device", "cpu", "--checkpoint", ck,
                               "--resume"])
    # the step count and the optimizer go on; the stream starts anew from
    # the seed, as in the JAX example
    assert again["start"] == 3 and all(np.isfinite(again["losses"]))
    with open(ck + ".meta") as f:
        assert json.load(f)["epoch"] == 6
    tokens = port_example.main(["generate", *SMALL, "--device", "cpu",
                                "--checkpoint", ck, "--temperature", "0",
                                "--length", "8"])
    assert tokens.shape == (1, 8)
    # the port's file, read by the JAX package, decodes to the same tokens
    np.testing.assert_array_equal(tokens, _jax_greedy(ck))
    with pytest.raises(NotImplementedError, match="mesh"):
        port_example.main(["train", *SMALL, *TRAIN, "--steps", "1",
                           "--device", "cpu", "--checkpoint", ck,
                           "--mesh", "dp=2"])


def test_jax_example_checkpoint_generates_in_the_port(port_example,
                                                      tmp_path,
                                                      monkeypatch, capsys):
    ck = str(tmp_path / "jax_ck")
    monkeypatch.setattr(sys, "argv", [
        "autoregressivelm.py", "train", *SMALL, *TRAIN, "--steps", "2",
        "--checkpoint", ck])
    _example("autoregressivelm").main()
    assert os.path.exists(ck + ".meta")
    tokens = port_example.main(["generate", *SMALL, "--device", "cpu",
                                "--checkpoint", ck, "--temperature", "0",
                                "--length", "8"])
    assert "loaded checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(tokens, _jax_greedy(ck))
