#!/usr/bin/env python
"""Batch-serving demo on the PyTorch/CUDA port: continuous batching over
the paged KV cache.

The port's counterpart of ``examples/serving_demo.py``, with the same flags
and defaults: loads (or initializes) a byte-level GPT language model,
admits several prompts behind the GPT ``BatchServer`` with the prefix cache
(pages of 32 tokens, 256 pages), decodes them concurrently through
``ServingEngine`` with requests finishing at different times, and prints
the completions. Its checkpoint is a loop state written by either
package's ``examples/autoregressivelm*.py`` at the same widths (the port's
``io.load_loop_state`` reads the JAX package's files). ``--device``
(default ``cuda``) is the one added flag.

Usage:
  python examples/serving_demo_torch.py --checkpoint lm_ck --tokens 60
  python examples/serving_demo_torch.py --device cpu --layers 1 --dim 32

``main(argv)`` returns what it did: the ``results`` ({request id: tokens}),
the ``server``, the ``tokens`` decoded and the ``seconds`` they took.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=40)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--prompts", nargs="*",
                    default=["the quick ", "once upon ", "in the beginning "])
    ap.add_argument("--device", default="cuda",
                    help="the torch device (cpu for a run without a card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)

    from lamp_tpu_torch import io as lio, nn, optim
    from lamp_tpu_torch.models import (BatchServer, SamplingParams,
                                       ServingEngine)

    device = torch.device(args.device)
    model = nn.LanguageModelModule.init(
        vocab_size=256, context_length=args.context, num_blocks=args.layers,
        embed_dim=args.dim, attention_heads=args.heads,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device,
    )
    if args.checkpoint and os.path.exists(args.checkpoint):
        opt = optim.AdamW(model.named_parameters(), 1e-3)
        lio.load_loop_state(args.checkpoint, model_template=model,
                            optimizer_state_template=opt)
        print("loaded checkpoint")

    server = BatchServer(model, page_size=32, total_pages=256,
                         enable_prefix_cache=True)
    engine = ServingEngine(server, decode_steps=8)
    for i, p in enumerate(args.prompts):
        # staggered budgets + per-request sampling exercise join/leave and
        # the heterogeneous sampler on the device
        engine.submit(
            list(p.encode()),
            SamplingParams(temperature=args.temperature, top_p=0.95,
                           max_tokens=args.tokens + 10 * i),
            request_id=f"req{i}",
        )

    t0 = time.perf_counter()
    results = engine.run()
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in results.values())
    print(f"decoded {total} tokens in {dt:.2f}s "
          f"({total / dt:.0f} tok/s aggregate); prefix cache "
          f"hit/miss tokens {server.cache_hit_tokens}/"
          f"{server.cache_miss_tokens}")
    for i, p in enumerate(args.prompts):
        text = bytes(results[f"req{i}"]).decode("utf-8", errors="replace")
        print(f"[{i}] {p!r} -> {text!r}")
    return dict(results=results, server=server, tokens=total, seconds=dt)


if __name__ == "__main__":
    main()
