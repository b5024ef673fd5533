"""PyTorch/CUDA port of :mod:`lamp_tpu` for NVIDIA Hopper.

Mirrors the JAX package's layout (``nn``, ``ops``, ``optim``, ``train``,
``models``, ``data``, ``io``) and its public names. It imports torch and never JAX, and
nothing of ``lamp_tpu`` (whose package import pulls in JAX). Each Pallas
kernel of the JAX package becomes a CUDA kernel written by hand for sm_90a,
in ``csrc/``, built with nvcc at its first CUDA use (``ops/_build.py``). On
CPU tensors every kernel wrapper takes its plain PyTorch version; on CUDA
tensors it launches the kernel or raises. Constructors and the bridge put
their tensors on the card unless asked for ``device="cpu"``.

Ported so far: the paged-KV serving path (``models.ModernBatchServer``,
``models.ServingEngine``) over ``nn.ModernLM``, and GPT language-model
training (``nn.LanguageModelModule``, ``optim.AdamW``,
``train.make_train_step``) over the flash-attention kernels, and quantized
serving (``ModernBatchServer(quantize_bits=4|8, kv_dtype=fp8)`` over the
int4 matmul kernel and fp8 KV pools; ``ops.quantize_model``), the fused
AdamW with stochastic rounding (``ops.AdamWStochastic``) and the opt-in
fused LayerNorm (``ops.fused_layernorm``), and packed-document ModernLM
training (``data.pack_documents``, ``nn.ModernLM.loss`` over
``ops.fused_lm_loss`` and the flash-attention kernels with segment ids),
and the serving path's per-request controls (penalties, constrained
decoding over ``models.TokenDFA``, multi-LoRA adapters from
``nn.lora_inject`` and ``models.LoRADraftSpeculativeDecoder``);
``bridge.load_modern_lm`` (LoRA factors included),
``bridge.load_language_model``,
``bridge.load_quantized_linear`` and ``bridge.load_adamw_state`` carry a JAX
model's weights, quantized layers and optimizer state across, and
``bridge.jax_entries`` / ``bridge.optimizer_entries`` / ``bridge.jax_tree``
give them back in JAX's layout and order. Checkpoints, the epoch loop and the LM example: ``io`` writes and
reads the JAX package's checkpoint files (loop state, sharded files,
safetensors, background saves), ``train.epochs`` / ``resumable_epochs``
drive training epoch by epoch over ``data.BatchStream`` with
``data.prefetch_to_device`` (pinned buffers, a side stream), ``data`` holds
the codecs (``ByteSegmentCodec``, with the ``native`` C++ encoder), and
``examples/autoregressivelm_torch.py`` trains, resumes and samples the GPT.
"""

from . import data, io, models, nn, ops, optim, train

__all__ = ["data", "io", "models", "nn", "ops", "optim", "train"]
