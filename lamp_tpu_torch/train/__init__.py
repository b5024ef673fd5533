"""Training loops.

Counterpart of :mod:`lamp_tpu.train`. Ported so far: ``TrainState``,
``make_train_step`` (``loss_calculation="simple"``, gradient accumulation)
``make_eval_step`` and ``packed_lm_loss`` (the loss function of
packed-document ``ModernLM`` training). ``one_epoch``, ``epochs``, the batch streams and
the other loss calculations are not ported yet.
"""

from .loops import TrainState, make_eval_step, make_train_step, packed_lm_loss

__all__ = ["TrainState", "make_eval_step", "make_train_step",
           "packed_lm_loss"]
