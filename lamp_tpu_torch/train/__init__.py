"""Training loops.

Counterpart of :mod:`lamp_tpu.train`. Ported so far: ``TrainState``,
``make_train_step`` (the ``simple``, ``adversarial`` and ``perturbed``
loss calculations, gradient accumulation), ``make_chained_train_step``,
``make_eval_step``, ``packed_lm_loss`` (the loss function of
packed-document ``ModernLM`` training), the epoch loop (``one_epoch``,
``validation_one_epoch``, ``epochs``, ``TrainingResult``), the inference
loop ``run_batch_stream``, and checkpointed training
(``resumable_epochs``, ``latest_loop_checkpoint``).
``parallel_run_batch_stream`` raises until the port's ``parallel``
exists; EMA, SWA, the preference and RL losses are not ported yet.
"""

from .loops import (TrainingResult, TrainState, epochs,
                    make_chained_train_step, make_eval_step, make_train_step,
                    one_epoch, packed_lm_loss, parallel_run_batch_stream,
                    run_batch_stream, validation_one_epoch)
from .resilience import latest_loop_checkpoint, resumable_epochs

__all__ = ["TrainState", "TrainingResult", "epochs",
           "make_chained_train_step", "make_train_step", "make_eval_step",
           "one_epoch", "validation_one_epoch", "run_batch_stream",
           "parallel_run_batch_stream", "packed_lm_loss",
           "resumable_epochs", "latest_loop_checkpoint"]
