"""Preemption-safe training: checkpoint every few epochs, resume by itself.

Counterpart of :mod:`lamp_tpu.train.resilience`:

    result = resumable_epochs(
        checkpoint_dir="ckpt", model=model, optimizer=opt, loss_fn=loss_fn,
        train_batches=..., epochs=100,
    )

Every ``every`` epochs the loop's whole state (the model, the optimizer's
state, the schedule's state, the learning curve and the minimum-validation
bookkeeping) is written through
:func:`lamp_tpu_torch.io.checkpoint.save_loop_state` as ``epoch-N`` and
``epoch-N.meta``, the JAX package's names and files. A run started again
with the same arguments resumes after the newest complete checkpoint, with
the same per-epoch generators (``epochs(resume_from=)``).
``background=True`` writes from a thread (``AsyncCheckpointer``) while the
next epoch runs, and waits for the last write before returning (JAX's
returns with it in flight).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

from .loops import TrainState, TrainingResult, _copy_state, epochs

__all__ = ["resumable_epochs", "latest_loop_checkpoint"]


def latest_loop_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Path of the newest complete loop checkpoint in ``checkpoint_dir``,
    or None. A checkpoint is complete once its ``.meta`` sidecar exists
    (``save_loop_state`` writes it last, atomically)."""
    if not os.path.isdir(checkpoint_dir):
        return None
    best = None
    for name in os.listdir(checkpoint_dir):
        if not name.endswith(".meta"):
            continue
        path = os.path.join(checkpoint_dir, name[: -len(".meta")])
        if not os.path.exists(path):
            continue
        ep = _epoch_of(path)
        if ep is not None and (best is None or ep > _epoch_of(best)):
            best = path
    return best


def _epoch_of(path: str) -> Optional[int]:
    name = os.path.basename(path)
    if name.startswith("epoch-") and name[len("epoch-"):].isdigit():
        return int(name[len("epoch-"):])
    return None


def resumable_epochs(*, checkpoint_dir: str, model, optimizer,
                     every: int = 1, keep: int = 2,
                     background: bool = False,
                     checkpoint_callback: Optional[Callable] = None,
                     log: Optional[Callable[[str], None]] = None,
                     **epochs_kwargs) -> TrainingResult:
    """:func:`lamp_tpu_torch.train.epochs` with checkpoints and resume.

    If ``checkpoint_dir`` holds a checkpoint of an earlier (preempted) run,
    ``model`` and ``optimizer`` are loaded from it in place and training
    resumes after its epoch; otherwise it starts fresh. The state is saved
    every ``every`` epochs and after the last, keeping the newest ``keep``
    checkpoints. The minimum-validation state, when ``epochs`` keeps one,
    is saved as the JAX ``TrainState`` (params, rest, opt_state, step).
    Other keyword arguments go to :func:`epochs`; a caller's
    ``checkpoint_callback`` runs after the save."""
    from ..io import checkpoint as ckpt_io

    if every < 1:
        raise ValueError("every must be >= 1")
    if keep < 1:
        raise ValueError("keep must be >= 1")
    if "state" in epochs_kwargs or "resume_from" in epochs_kwargs:
        raise ValueError(
            "resumable_epochs owns state/resume_from; pass model= instead")
    os.makedirs(checkpoint_dir, exist_ok=True)

    state = TrainState.init(model, optimizer)
    resume_from = None
    latest = latest_loop_checkpoint(checkpoint_dir)
    if latest is not None:
        with open(latest + ".meta") as f:
            meta = json.load(f)
        extra = meta.get("extra") or {}
        loaded, meta = ckpt_io.load_loop_state(
            latest, model_template=model, optimizer_state_template=optimizer,
            min_validation_model_template=(
                _copy_state(state) if extra.get("has_min_state") else None))
        state.step = extra.get("step") or 0
        resume_from = dict(meta)
        resume_from["min_validation_state"] = loaded["min_validation_model"]
        resume_from["smoothed_validation_loss"] = extra.get(
            "smoothed_validation_loss")
        resume_from["min_validation_epoch"] = extra.get(
            "min_validation_epoch")
        resume_from["validation_loss"] = meta.get("last_validation_loss")
        if log:
            log(f"resuming from {latest} (epoch {meta['epoch']})")

    last_epoch = epochs_kwargs.get("epochs")

    def save(st: TrainState, payload) -> None:
        epoch = payload["epoch"]
        due = (epoch + 1) % every == 0 or epoch + 1 == last_epoch
        if due:
            path = os.path.join(checkpoint_dir, f"epoch-{epoch}")
            min_state = payload.get("min_validation_state")
            ckpt_io.save_loop_state(
                path,
                model=st.model,
                optimizer_state=st.optimizer,
                epoch=epoch,
                last_validation_loss=payload.get("validation_loss"),
                min_validation_loss=payload.get("min_validation_loss"),
                min_validation_model=min_state,
                learning_curve=payload.get("learning_curve"),
                lr_state=payload.get("lr_state"),
                extra={
                    "step": int(st.step),
                    "has_min_state": min_state is not None,
                    "smoothed_validation_loss":
                        payload.get("smoothed_validation_loss"),
                    "min_validation_epoch":
                        payload.get("min_validation_epoch"),
                },
                background=background)
            _prune(checkpoint_dir, keep)
        if checkpoint_callback is not None:
            checkpoint_callback(st, payload)

    try:
        return epochs(state=state, optimizer=optimizer,
                      resume_from=resume_from, checkpoint_callback=save,
                      log=log, **epochs_kwargs)
    finally:
        if background:  # the last save is on disk when this returns
            ckpt_io.wait_for_background_saves()


def _prune(checkpoint_dir: str, keep: int) -> None:
    done = sorted(
        (p for p in (
            os.path.join(checkpoint_dir, n[: -len(".meta")])
            for n in os.listdir(checkpoint_dir) if n.endswith(".meta")
        ) if _epoch_of(p) is not None),
        key=_epoch_of)
    for path in done[:-keep]:
        for suffix in (".meta", ".data", ""):
            try:
                os.remove(path + suffix)
            except OSError:
                pass
