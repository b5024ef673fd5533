#!/usr/bin/env python
"""Serve a model over an OpenAI-compatible HTTP API, on the PyTorch/CUDA
port.

The port's counterpart of ``examples/openai_server.py``, with the same
flags and defaults: a byte-level ``ModernLM`` (random weights from seed 0,
or a loop state from a checkpoint) behind ``ModernBatchServer`` with the
prefix cache, a continuous-batching ``ServingEngine``, and the
``OpenAIHTTPServer`` (``/v1/completions`` and ``/v1/chat/completions``
with SSE streaming, stop strings, parallel sampling, and a Prometheus
``/metrics`` endpoint) over ``IdentityCodec``. ``--device`` (default
``cuda``) is the one added flag.

Usage:
    python examples/openai_server_torch.py --port 8000 --checkpoint lm_ck
    curl localhost:8000/v1/completions -d '{"prompt": "once upon ", "max_tokens": 40}'
    curl -N localhost:8000/v1/completions -d '{"prompt": "the ", "stream": true}'

``serve(argv)`` builds the server and returns it started (``port=0``
binds a free port: ``.port`` has it; ``.shutdown()`` stops it);
``main(argv)`` serves until interrupted.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--total-pages", type=int, default=512)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="the torch device (cpu for a run without a card)")
    return ap.parse_args(argv)


def serve(argv=None):
    """Build the model, the engine and the HTTP front end, start serving
    (the engine and the HTTP server each on a thread of their own) and
    return the :class:`OpenAIHTTPServer`."""
    args = parse(argv)

    from lamp_tpu_torch import io as lio, nn, optim
    from lamp_tpu_torch.data.tokenizer import IdentityCodec
    from lamp_tpu_torch.models.openai_api import (OpenAIFrontend,
                                                  OpenAIHTTPServer)
    from lamp_tpu_torch.models.serving import ModernBatchServer, ServingEngine

    device = torch.device(args.device)
    model = nn.ModernLM.init(
        vocab_size=256, context_length=args.context, num_blocks=args.layers,
        embed_dim=args.dim, num_heads=args.heads,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        lio.load_loop_state(
            args.checkpoint, model_template=model,
            optimizer_state_template=optim.AdamW(model.named_parameters(),
                                                 1e-3))
        print(f"loaded {args.checkpoint}")

    server = ModernBatchServer(model, page_size=args.page_size,
                               total_pages=args.total_pages,
                               enable_prefix_cache=True)
    engine = ServingEngine(server, decode_steps=args.decode_steps,
                           max_batch=args.max_batch)
    api = OpenAIHTTPServer(
        OpenAIFrontend(engine, IdentityCodec(), model_name="lamp-byte-lm",
                       default_max_tokens=64),
        host=args.host, port=args.port)
    api.start()
    print(f"serving on http://{args.host}:{api.port}/v1  "
          f"(metrics: /metrics, health: /health)", flush=True)
    return api


def main(argv=None):
    api = serve(argv)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        api.shutdown()


if __name__ == "__main__":
    main()
