#!/usr/bin/env python
"""Byte-level GPT language model on the PyTorch/CUDA port: train / generate.

The port's counterpart of ``examples/autoregressivelm.py``, with the same
subcommands, flags and defaults: a 12-layer, 768-wide, 12-head GPT with
bf16 parameters, context 384, byte vocabulary 256 (or a trained
``ByteSegmentCodec``), AdamW with f32 masters, beta2 0.95, clip 1.0 and
weight decay off on biases, norms, scales and embeddings, batch 8 x 5
accumulation, cosine schedule with warmup, checkpoint and resume, and
temperature sampling through the KV-cached ``models.generate``. Its
checkpoint is the JAX example's file: either example resumes or samples
from the other's.

As in the JAX example, ``--resume`` continues the step count, the
schedule and the optimizer's state from the checkpoint but draws the
batch stream anew from ``--seed``; the checkpoint is written every 500
steps (at step 499, 999, ...) and after the last step. ``--device``
(default ``cuda``) is the one added flag; ``--mesh`` raises until the
port's ``parallel`` exists.

Usage:
  python examples/autoregressivelm_torch.py train --corpus file.txt --steps 1000
  python examples/autoregressivelm_torch.py generate --checkpoint ck --prompt "The "
  python examples/autoregressivelm_torch.py train --corpus f --device cpu ...

``main(argv)`` runs in-process and returns what it did: for ``train`` a
dict (``start`` step, per-step ``losses``, ``tokens``, the steps' ``ms``
by CUDA events on the card, else wall time, and the final ``state``), for
``generate`` the sampled tokens [1, length].
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def build_model(args, generator, device):
    from lamp_tpu_torch import nn

    return nn.LanguageModelModule.init(
        vocab_size=args.vocab_size,
        context_length=args.context,
        num_blocks=args.layers,
        embed_dim=args.dim,
        attention_heads=args.heads,
        dropout=args.dropout,
        generator=generator,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=device,
    )


def make_optimizer(args, model):
    """AdamW over ``model``: for ``train`` the example's (beta2, clip 1.0,
    no weight decay on norms, biases, scales and embeddings), for
    ``generate`` a plain one whose state has the same layout, so that the
    checkpoint loads into it."""
    from lamp_tpu_torch import nn, optim

    training = args.cmd == "train"
    return optim.AdamW(
        model.named_parameters(),
        args.learning_rate if training else 1e-3,
        beta2=args.beta2 if training else 0.999,
        clip=1.0 if training else None,
        weight_decay=(
            lambda tag: 0.0 if (
                "bias" in tag or "LayerNorm" in tag or "scale" in tag
                or "Embedding" in tag
            ) else args.weight_decay
        ) if training else 0.0,
        tags=nn.param_tags(model),
    )


def loss_fn(model, batch, generator, train_mode):
    """The LM loss of a (tokens, targets) batch and its number of rows."""
    from lamp_tpu_torch import nn

    tokens, target = batch
    logits = model(tokens.long(), train=train_mode, generator=generator)
    return nn.lm_loss(logits, target.long()), tokens.shape[0]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--layers", type=int, default=12)
        p.add_argument("--dim", type=int, default=768)
        p.add_argument("--heads", type=int, default=12)
        p.add_argument("--context", type=int, default=384)
        p.add_argument("--vocab-size", type=int, default=256)
        p.add_argument("--dropout", type=float, default=0.0)
        p.add_argument("--bf16", action="store_true", default=True)
        p.add_argument("--no-bf16", dest="bf16", action="store_false")
        p.add_argument("--checkpoint", default="lm_checkpoint")
        p.add_argument("--bpe", default=None,
                       help="path to a trained ByteSegmentCodec json")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda",
                       help="the torch device (cpu for a run without a card)")

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--corpus", required=True)
    t.add_argument("--steps", type=int, default=1000)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--grad-accum", type=int, default=5)
    t.add_argument("--learning-rate", type=float, default=3e-4)
    t.add_argument("--weight-decay", type=float, default=0.01)
    # the reference LM example trains with beta2=0.95, the GPT convention
    t.add_argument("--beta2", type=float, default=0.95)
    t.add_argument("--warmup-steps", type=int, default=100)
    t.add_argument("--mesh", default=None,
                   help="e.g. 'dp=8' (not ported: raises)")
    t.add_argument("--resume", action="store_true")

    g = sub.add_parser("generate")
    common(g)
    g.add_argument("--prompt", default="The ")
    g.add_argument("--length", type=int, default=200)
    g.add_argument("--temperature", type=float, default=0.8)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)

    from lamp_tpu_torch import data, io as lio, models, optim, train

    device = torch.device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(args, generator, device)
    optimizer = make_optimizer(args, model)
    codec = (data.ByteSegmentCodec.load(args.bpe) if args.bpe
             else data.IdentityCodec())

    if args.cmd == "generate":
        if os.path.exists(args.checkpoint):
            lio.load_loop_state(args.checkpoint, model_template=model,
                                optimizer_state_template=optimizer)
            print("loaded checkpoint")
        prompt_tokens = codec.encode(args.prompt.encode())
        out = models.generate(
            model, prompt_tokens[None, :], args.length,
            temperature=args.temperature,
            generator=torch.Generator(device=device).manual_seed(args.seed))
        text = codec.decode(out[0])
        print(args.prompt + text.decode("utf-8", errors="replace"))
        return out

    if args.mesh:
        raise NotImplementedError("--mesh (the port has no parallel "
                                  "package yet)")
    with open(args.corpus, "rb") as f:
        corpus = codec.encode(f.read())
    print(f"corpus: {len(corpus)} tokens")
    state = train.TrainState.init(model, optimizer)
    if args.resume and os.path.exists(args.checkpoint):
        _, meta = lio.load_loop_state(args.checkpoint, model_template=model,
                                      optimizer_state_template=optimizer)
        state.step = meta["epoch"]
        print(f"resumed from step {meta['epoch']}")
    step = train.make_train_step(optimizer, loss_fn,
                                 accumulation_steps=args.grad_accum)
    schedule = optim.schedules.cosine_with_warmup(args.warmup_steps,
                                                  args.steps)
    rng = np.random.default_rng(args.seed)
    stream = data.autoregressive_minibatches_from_corpus(
        corpus, args.batch_size * args.grad_accum, args.context,
        batches_per_epoch=args.steps, rng=rng)
    on_card = device.type == "cuda"
    if on_card:
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    t0 = time.perf_counter()
    tokens_done = 0
    start = int(state.step)
    for i, (x, y) in enumerate(data.prefetch_to_device(stream,
                                                       device=device)):
        gstep = start + i
        _, lr_factor = schedule(None, gstep, None)
        if args.grad_accum > 1:
            x = x.reshape(args.grad_accum, args.batch_size, -1)
            y = y.reshape(args.grad_accum, args.batch_size, -1)
        if on_card and i == 0:
            begin.record()
        state, (loss, n) = step(state, (x, y), generator, lr_factor)
        losses.append(loss)
        tokens_done += args.batch_size * args.grad_accum * args.context
        if gstep % 50 == 0:
            dt = time.perf_counter() - t0
            print(f"step {gstep} loss {float(loss):.4f} "
                  f"{tokens_done / max(dt, 1e-9):.0f} tok/s")
        last = i == len(stream) - 1
        if on_card and last:
            end.record()
        if gstep % 500 == 499 or last:
            lio.save_loop_state(args.checkpoint, model=model,
                                optimizer_state=optimizer, epoch=gstep + 1)
            print(f"checkpointed at step {gstep}")
    if on_card:
        torch.cuda.synchronize(device)
        ms = begin.elapsed_time(end)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    return dict(start=start, losses=[float(v) for v in losses],
                tokens=tokens_done, ms=ms, state=state)


if __name__ == "__main__":
    main()
