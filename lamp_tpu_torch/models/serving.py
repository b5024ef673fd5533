"""Batch LM serving over the paged KV cache.

Counterpart of :mod:`lamp_tpu.models.serving`: a continuous-batching decode
engine in which concurrent sequences of different lengths share one
physical page pool, and requests join and leave the batch between steps.
:class:`BatchServer` serves the GPT family
(:class:`~lamp_tpu_torch.nn.LanguageModelModule`: learned positions,
pre-norm blocks, biased projections) and :class:`ModernBatchServer` the
llama-style :class:`~lamp_tpu_torch.nn.ModernLM`; both share the page pool,
the request lifecycle, sampling and the decode loop.

    server = ModernBatchServer(model, page_size=128, total_pages=192)
    engine = ServingEngine(server, decode_steps=8)
    engine.submit(prompt_tokens, SamplingParams(max_tokens=64))
    results = engine.run()          # {request_id: [tok, ...]}

The server runs on the device of its model's parameters. Each decode step
runs the model eagerly on that device; per layer, the hand-written paged
attention kernel (:func:`~lamp_tpu_torch.ops.paged_attention`) attends over
the pool plus the current token, and all layers' new K/V rows are written
into the pool by one scatter after the layer loop. Prefill is a dense
forward of the prompt with the plain attention and the float weights.

Quantized serving: ``ModernBatchServer(model, quantize_bits=4)`` packs every
decode matmul's weight (fused QKV, out-projection, the three SwiGLU
matrices and the logits matrix) into int4 and multiplies by it with the
hand-written int4 kernel (:func:`~lamp_tpu_torch.ops.int4_matmul`);
``quantize_bits=8`` into per-channel int8 with ``torch._int_mm``.
``kv_dtype=torch.float8_e4m3fn`` (or ``float8_e5m2``) stores the KV pool in
fp8, which the paged-attention kernel reads directly.

Chunked decode and speculative decoding: :meth:`BatchServer.advance_chunk`
scores m tokens of every sequence in one call (each layer writes the
chunk's K/V rows into the pool, then the paged kernel attends over B*m
query rows), :meth:`BatchServer.rewind` drops a sequence's last tokens, and
:class:`SpeculativeDecoder` drives a draft server (often
:func:`draft_view` of the target: its first blocks, sharing the target's
tensors) and verifies its proposals with one chunk of the target a round:

    spec = SpeculativeDecoder(model, draft_view(model, 3), k=4,
                              server_cls=functools.partial(
                                  ModernBatchServer, quantize_bits=4))
    spec.add("a", prompt_tokens)
    emitted = spec.step()           # {"a": [tok, ...]}, 1 to k tokens

Under ``quantize_bits=4`` a chunk of B*k > 64 rows runs the int4 kernel's
row-tiled route.

Shared KV pages: ``ModernBatchServer(model, enable_prefix_cache=True)``
content-addresses every full prompt page by a chain hash of its tokens; a
later prompt with the same prefix shares those physical pages (refcounted,
kept on an LRU once no sequence holds them) and prefills only its uncached
tail, as one chunk through :meth:`~ModernBatchServer._decode_chunk`. The
first write into a shared page copies it (copy-on-write). On that
machinery :meth:`BatchServer.fork` duplicates a sequence without copying
its KV, :meth:`ServingEngine.submit` fans a request into ``n`` / ``best_of``
sampled branches, and :class:`BeamSearchDecoder` keeps its beams:

    server = ModernBatchServer(model, enable_prefix_cache=True)
    hyps = BeamSearchDecoder(server, beams=4).decode(prompt, max_tokens=32)

Per-request controls: ``SamplingParams(presence_penalty=,
frequency_penalty=, repetition_penalty=)`` (a [B, V] count stack on the
device, cached per batch composition and bumped inside the decode loop),
``constraint=`` (a :class:`~lamp_tpu_torch.models.constrained.TokenDFA`
registered with :meth:`BatchServer.register_constraint`: one stacked
transition table whose gathered rows mask the logits and advance each
request's state), and ``adapter=`` (a LoRA adapter registered with
:meth:`ModernBatchServer.register_adapter`: one batch mixes adapters, each
row's low-rank delta added beside the shared base matmuls by two
``torch.bmm`` a projection). :class:`LoRADraftSpeculativeDecoder` drafts
with the target's first blocks plus an adapter, on the target's own
tensors:

    server.register_adapter("fr", lora_inject(model, rank=8, generator=g))
    server.register_constraint("json", TokenDFA.compile(
        json_value_regex(3), vocab_bytes, eos_token=eos))
    engine.submit(prompt, SamplingParams(presence_penalty=0.5),
                  adapter="fr", constraint="json")

MoE models: a ModernLM with :class:`~lamp_tpu_torch.nn.SwiGLUMoE` blocks
(``moe_experts``, or a Mixtral import) decodes its MLPs by dense dispatch,
every expert over the step's few rows, combined by the top-k gates, as
the JAX server does; ``quantize_bits=8`` stores the experts in int8 per
expert and output channel and multiplies by ``torch._int_mm``. The prefill
runs each block's own MLP.

Not ported yet (each raises ``NotImplementedError`` when asked for):
tensor parallelism (``mesh=``). As in the JAX package, a MoE model takes
neither ``quantize_bits=4`` nor adapters, the GPT :class:`BatchServer`
takes no ``quantize_bits`` (``ValueError``) and no adapter
(``NotImplementedError``), and :class:`LoRADraftSpeculativeDecoder` serves
the ModernLM family only. A ModernLM whose attention projections carry
biases (a Qwen2 import) raises ``NotImplementedError``: the JAX server
leaves the biases out of its decode step and its prefill
(``lamp_tpu/models/serving.py:1575-1578``, ``:1616-1690``, ``:1970-1976``)
and so serves other tokens than the model's.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.lora import LoRALinear
from ..nn.modern import ModernLM, apply_rope
from ..nn.moe import SwiGLUMoE, moe_combine, swiglu_moe_dense
from ..ops.attention import mha_reference
from ..ops.paged_attention import paged_attention
from ..ops.quantization import (int4_group_size, int4_matmul, int8_matmul,
                                int_mm, quantize_int4, quantize_int8)
from .sampling import NUCLEUS_CAND, SamplingParams, sample_tokens

__all__ = ["BatchServer", "BeamSearchDecoder", "LoRADraftSpeculativeDecoder",
           "ModernBatchServer", "ServingEngine", "SamplingParams",
           "SpeculativeDecoder", "draft_view"]


def _bump_counts(counts, nxt):
    """counts [B, V] += one_hot(nxt), in place."""
    rows = torch.arange(nxt.shape[0], device=counts.device)
    counts.index_put_((rows, nxt), torch.ones_like(nxt, dtype=counts.dtype),
                      accumulate=True)


def _kv_write_stacked(pool, total_pages, token_pages, token_slots,
                      deferred_rows):
    """ONE scatter writes every layer's deferred K and V rows into the
    layer-stacked fused pool ``[L*P, 2, page, F]`` (layer ``li`` owns
    physical rows ``[li*P, (li+1)*P)``). ``deferred_rows`` is the decode
    loop's per-layer ``[(k_rows [B, F], v_rows [B, F]), ...]`` list.

    The pool is updated in place (``index_put_``), where the JAX package
    relied on buffer donation for the same effect."""
    layers = len(deferred_rows)
    b = token_pages.shape[0]
    dev = pool.device
    off = torch.arange(layers, device=dev) * total_pages
    pages_l = (off[:, None] + token_pages.long()[None, :]).reshape(-1)
    pages2 = torch.cat([pages_l, pages_l])
    sel = torch.cat([torch.zeros(layers * b, dtype=torch.long, device=dev),
                     torch.ones(layers * b, dtype=torch.long, device=dev)])
    slots_l = token_slots.long().repeat(layers)
    slots2 = torch.cat([slots_l, slots_l])
    rows = torch.cat([r for r, _ in deferred_rows]
                     + [r for _, r in deferred_rows]).to(pool.dtype)
    pool.index_put_((pages2, sel, slots2), rows)


class BatchServer:
    """Paged-KV batch decode for the GPT family
    (:class:`~lamp_tpu_torch.nn.LanguageModelModule`; see
    :class:`ModernBatchServer` for the llama-style family): the page pool,
    the request lifecycle, sampling and the multi-step decode loop, and
    the GPT's model hooks (``_introspect``, ``_precompute_extras``,
    ``_prefill_seq``, ``_decode_step``, ``_decode_chunk``), which
    :class:`ModernBatchServer` overrides.

    As the JAX server does, the GPT hooks assume pre-norm blocks and softmax
    attention (whatever the blocks' ``gpt_order`` and ``linearized`` say),
    one kv head a query head, and no per-layer window. A projection's
    product is rounded to the activations' dtype before its bias is added,
    in the JAX server's order."""

    def _introspect(self, model):
        block = model.encoder.blocks[0]
        self.layers = len(model.encoder.blocks)
        self.heads = block.attention.num_heads
        self.kv_heads = self.heads
        # the port's Linear is [out, in]: the q width is the first axis
        self.head_dim = block.attention.w_q.weight.shape[0] // self.heads
        self._windows = tuple(None for _ in range(self.layers))

    def __init__(self, model, *, page_size: int = 128,
                 total_pages: int = 512, temperature: float = 0.0,
                 seed: int = 0, quantize_bits: Optional[int] = None,
                 enable_prefix_cache: bool = False, kv_dtype=None):
        if quantize_bits not in (None, 4, 8):
            raise ValueError("quantize_bits must be None, 4 or 8")
        self.quantize_bits = quantize_bits
        self.enable_prefix_cache = enable_prefix_cache
        self.model = model
        self._introspect(model)
        self.device = model.token_embedding.weight.device
        self.page_size = page_size
        self.total_pages = total_pages
        self.max_pages_per_seq = (
            model.context_length + page_size - 1) // page_size
        # kv_dtype=torch.float8_e4m3fn (or float8_e5m2) stores the pool in
        # fp8: half the KV memory of bf16, and half the bytes the paged
        # kernel reads; the pool write rounds each K/V row to fp8
        dt = model.token_embedding.weight.dtype if kv_dtype is None else kv_dtype
        self.kv_dtype = dt
        # ONE layer-stacked FUSED pool [L*P, 2, page, H_kv*D]: layer li owns
        # physical page rows [li*P, (li+1)*P); within a page, index 0 holds
        # its keys, 1 its values. The kernel addresses layer li with
        # page_offset=li*P, and one scatter per step writes every layer.
        self.kv_pages = torch.zeros(
            (self.layers * total_pages, 2, page_size,
             self.kv_heads * self.head_dim), dtype=dt, device=self.device)
        # page 0 is the "trash" page, never handed out: released page-table
        # entries point at it (masked by the window), so page tables match
        # the JAX server's
        self.free_pages: List[int] = list(range(total_pages - 1, 0, -1))
        self.seq_pages: Dict = {}
        self.seq_len: Dict = {}
        self.last_token: Dict = {}
        self.seq_params: Dict = {}
        # per-request attention window (None = model default) and the count
        # of leading logical pages already released back to the pool because
        # they fell fully below every layer's sliding-window band
        self.seq_window: Dict = {}
        self.seq_released: Dict = {}
        self.seq_logprobs: Dict = {}
        self.seq_adapter: Dict = {}  # LoRA adapter index (0 = the base)
        self.vocab = model.token_embedding.weight.shape[0]
        # penalty state: host prompt masks per request; the [B, V] count
        # stack lives on the device, cached per batch composition
        # (_pen_stacks: surviving rows gathered, new or dirty rows zeroed)
        self.seq_prompt_mask: Dict = {}
        self._pen_cache = None  # (ids tuple, counts [B, V], pmask [B, V])
        self._pen_dirty: set = set()
        # constrained decoding: every registered TokenDFA's transitions in
        # ONE [sum of states, V] int32 device table whose row 0 is the free
        # automaton (every token allowed, a self-loop)
        self._constraints: Dict = {}
        self._c_offsets: Dict = {}
        self._ctable_host = np.zeros((1, self.vocab), np.int32)
        self._ctable_dev = None
        self.seq_cstate: Dict = {}
        # LoRA adapters (ModernBatchServer.register_adapter): name -> index
        # into the stacked factors (0 = the all-zero base)
        self._adapters: Dict[str, int] = {}
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps_decoded = 0  # decode steps run (each: one kernel per layer)
        # every page a sequence holds is refcounted. Under the prefix cache
        # full prompt pages are content-addressed by a chain hash over
        # page-sized token chunks, and later prompts with the same prefix
        # share the physical pages. A page whose count drops to 0 stays
        # cached on an LRU until the allocator reclaims it; the first write
        # into a shared page copies it (copy-on-write)
        self._page_refs: Dict[int, int] = {}
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.cache_hit_tokens = 0
        self.cache_miss_tokens = 0
        self.cow_copies = 0  # pages copied on write
        self._extras = self._precompute_extras(model)

    # -- request lifecycle --------------------------------------------------
    def add(self, seq_id, prompt_tokens,
            params: Optional[SamplingParams] = None,
            adapter: Optional[str] = None,
            window: Optional[int] = None,
            constraint: Optional[str] = None) -> None:
        """Admit a request: dense prefill of all but the last prompt token,
        whose K/V rows are written into freshly allocated pages. ``params``
        sets per-request sampling controls, penalties included (default:
        the server-level ``temperature``). ``adapter`` names a LoRA adapter
        registered with :meth:`ModernBatchServer.register_adapter`: its
        prompt prefills through the chunk path (:meth:`_prefill_suffix`),
        which carries the adapter, where the dense prefill does not.
        ``window`` caps THIS request's attention to its last ``window``
        tokens (the tighter of it and a layer's window wins); when every
        layer ends up windowed, pages that fall below the band are released
        back to the pool mid-generation. ``constraint`` names a
        :meth:`register_constraint`-ed TokenDFA that masks the request's
        sampling.

        Under ``enable_prefix_cache`` the longest run of cached full pages
        of the prompt is shared instead of recomputed, and only the tail
        after it is prefilled (:meth:`_prefill_suffix`)."""
        if seq_id in self.seq_pages:
            raise ValueError(f"duplicate request {seq_id}")
        if window is not None:
            window = int(window)
            if window <= 0:
                raise ValueError("window must be a positive int")
        if constraint is not None and constraint not in self._c_offsets:
            raise ValueError(f"unknown constraint {constraint!r}")
        aidx = self._adapter_index(adapter)
        if constraint is not None:
            # the global state index into the stacked table (the DFA's
            # start is its first row)
            self.seq_cstate[seq_id] = self._c_offsets[constraint]
        self.seq_adapter[seq_id] = aidx
        sp = params or SamplingParams(temperature=self.temperature)
        self.seq_window[seq_id] = window
        self.seq_released[seq_id] = 0
        self.seq_params[seq_id] = sp
        if sp.logprobs:
            self.seq_logprobs[seq_id] = []
        if sp.has_penalties:
            mask = np.zeros(self.vocab, bool)
            mask[np.asarray(prompt_tokens).reshape(-1)] = True
            self.seq_prompt_mask[seq_id] = mask
            self._pen_dirty.add(seq_id)
        self.seq_pages[seq_id] = []
        self.seq_len[seq_id] = 0
        prompt = np.asarray(prompt_tokens).reshape(-1)
        n_prefill = len(prompt) - 1
        matched = 0
        hashes = []
        if self.enable_prefix_cache and n_prefill > 0:
            # the salt partitions the cache: an adapter and a window both
            # change the K/V of every later layer for the same tokens
            hashes = self._prefix_hashes(
                prompt[:-1],
                salt=(f"{aidx}:{window}".encode()
                      if aidx or window is not None else b""))
            pages = self.seq_pages[seq_id]
            for h in hashes:
                pg = self._hash_to_page.get(h)
                if pg is None:
                    break
                self._incref(pg)
                pages.append(pg)
            matched = len(pages) * self.page_size
            self.seq_len[seq_id] = matched
            self.cache_hit_tokens += matched
            self.cache_miss_tokens += n_prefill - matched
        if matched > 0 or (aidx and n_prefill > 0):
            # the tail attends over the shared pages: one chunk (an
            # adapter's whole prompt too: the chunk path carries the delta)
            self._prefill_suffix(seq_id, prompt[matched:-1])
        elif n_prefill > 0:
            slots = []
            for _ in range(n_prefill):
                slots.append(self._alloc_slot(seq_id))
                self.seq_len[seq_id] += 1
            dev = self.device
            self._prefill_seq(
                torch.as_tensor(prompt[:-1].astype(np.int64), device=dev),
                torch.as_tensor([p for p, _ in slots], device=dev),
                torch.as_tensor([s for _, s in slots], device=dev),
                req_window=window,
            )
        if hashes:
            self._register_pages(seq_id, hashes)
        self.last_token[seq_id] = int(prompt[-1])
        self._release_pages(seq_id)

    def remove(self, seq_id) -> None:
        for pg in self.seq_pages.pop(seq_id):
            if pg >= 0:
                self._decref(pg)
        self.seq_len.pop(seq_id)
        self.last_token.pop(seq_id)
        self.seq_params.pop(seq_id, None)
        self.seq_window.pop(seq_id, None)
        self.seq_released.pop(seq_id, None)
        self.seq_logprobs.pop(seq_id, None)
        self.seq_adapter.pop(seq_id, None)
        self.seq_cstate.pop(seq_id, None)
        self.seq_prompt_mask.pop(seq_id, None)
        self._pen_dirty.discard(seq_id)

    def fork(self, src_id, dst_id) -> None:
        """Duplicate a sequence's decode state without copying its KV: the
        child references the parent's physical pages (refcounted), and the
        first write into the shared tail page copies it
        (:meth:`_alloc_slot`). Needs ``enable_prefix_cache=True``, which
        owns the refcounts and the copy-on-write. The child keeps the
        parent's adapter, constraint state and penalties; its penalty
        counts start at zero (it is marked dirty), as in the JAX server."""
        if not self.enable_prefix_cache:
            raise RuntimeError("fork requires enable_prefix_cache=True")
        if dst_id in self.seq_pages:
            raise ValueError(f"duplicate request {dst_id}")
        if src_id not in self.seq_pages:
            raise KeyError(f"unknown request {src_id}")
        for pg in self.seq_pages[src_id]:
            if pg >= 0:
                self._incref(pg)
        self.seq_pages[dst_id] = list(self.seq_pages[src_id])
        self.seq_len[dst_id] = self.seq_len[src_id]
        self.last_token[dst_id] = self.last_token[src_id]
        self.seq_params[dst_id] = self.seq_params[src_id]
        self.seq_adapter[dst_id] = self.seq_adapter.get(src_id, 0)
        self.seq_window[dst_id] = self.seq_window.get(src_id)
        self.seq_released[dst_id] = self.seq_released.get(src_id, 0)
        if src_id in self.seq_cstate:
            self.seq_cstate[dst_id] = self.seq_cstate[src_id]
        if src_id in self.seq_logprobs:
            self.seq_logprobs[dst_id] = list(self.seq_logprobs[src_id])
        if src_id in self.seq_prompt_mask:
            self.seq_prompt_mask[dst_id] = self.seq_prompt_mask[src_id].copy()
            self._pen_dirty.add(dst_id)

    # -- prefix cache ----------------------------------------------------
    def _prefix_hashes(self, prompt_kv, salt: bytes = b"") -> List[bytes]:
        """Chain hash (sha256) of each FULL page-sized chunk of the
        prompt's KV tokens, as int64 bytes: hash i commits to every token
        up to the end of chunk i, and to ``salt``."""
        ps = self.page_size
        out = []
        h = salt
        for i in range(len(prompt_kv) // ps):
            chunk = np.asarray(prompt_kv[i * ps:(i + 1) * ps],
                               np.int64).tobytes()
            h = hashlib.sha256(h + chunk).digest()
            out.append(h)
        return out

    def _register_pages(self, seq_id, hashes) -> None:
        """Content-address this request's full prompt pages, so that later
        requests can share them."""
        pages = self.seq_pages[seq_id]
        for h, pg in zip(hashes, pages):
            if h in self._hash_to_page or pg in self._page_hash:
                continue
            self._hash_to_page[h] = pg
            self._page_hash[pg] = h

    def _prefill_suffix(self, seq_id, suffix) -> None:
        """Prefill the uncached tail after a prefix-cache hit: ONE chunk of
        the sequence's m = len(suffix) tokens (:meth:`_decode_chunk`, B=1),
        whose rows attend over the shared pages and over each other. (The
        JAX server pads m to a bucket to bound its jit traces, with the
        pad rows written to the trash page; here the padding is left out,
        as :meth:`ModernBatchServer._prefill_seq` leaves out its own.)"""
        if len(suffix):
            self._run_chunk([seq_id], torch.as_tensor(
                np.asarray(suffix, np.int64)[None], device=self.device))

    def _incref(self, pg: int) -> None:
        r = self._page_refs.get(pg, 0)
        if r == 0:
            self._lru.pop(pg, None)  # back in use
        self._page_refs[pg] = r + 1

    def _decref(self, pg: int) -> None:
        """A sequence lets go of page ``pg``: with no holder left the page
        stays cached (reclaimable) if it is content-addressed, else it is
        free. (Without the prefix cache no page is shared or addressed, so
        this frees it.)"""
        r = self._page_refs.get(pg, 1) - 1
        if r > 0:
            self._page_refs[pg] = r
            return
        self._page_refs.pop(pg, None)
        if pg in self._page_hash:
            self._lru[pg] = None  # cached KV, reclaimable
            self._lru.move_to_end(pg)
        else:
            self.free_pages.append(pg)

    def _take_page(self) -> int:
        """A free page, else the least recently used cached one (whose hash
        entry goes with it)."""
        if self.free_pages:
            return self.free_pages.pop()
        if self._lru:
            pg, _ = self._lru.popitem(last=False)
            self._invalidate_page(pg)
            return pg
        raise RuntimeError("KV page pool exhausted")

    def _invalidate_page(self, pg: int) -> None:
        h = self._page_hash.pop(pg, None)
        if h is not None and self._hash_to_page.get(h) == pg:
            del self._hash_to_page[h]

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: page ``src``'s K and V rows of EVERY layer of the
        stacked pool to page ``dst``, in place, by one gather and one
        scatter (rows ``li*P + src`` to ``li*P + dst``). An fp8 pool is
        copied through its uint8 view: CUDA's indexing does not take every
        fp8 dtype."""
        off = torch.arange(self.layers, device=self.device) * self.total_pages
        pool = self.kv_pages
        if pool.element_size() == 1:
            pool = pool.view(torch.uint8)
        pool[off + dst] = pool[off + src]
        self.cow_copies += 1

    # -- sliding-window KV release ---------------------------------------
    def kv_bound_for(self, window: Optional[int] = None) -> Optional[int]:
        """Max tokens of history ANY layer can still attend for a request
        with per-request ``window``, or None when some layer is unbounded.
        bound = max over layers of min(layer window, request window)."""
        bound = 0
        for w in self._windows:
            if w is None and window is None:
                return None
            eff = (w if window is None
                   else (window if w is None else min(w, window)))
            bound = max(bound, eff)
        return bound

    def _kv_bound(self, seq_id) -> Optional[int]:
        return self.kv_bound_for(self.seq_window.get(seq_id))

    def _release_pages(self, seq_id) -> None:
        """Free leading logical pages whose every token is below the
        sliding-window band for ALL layers. Freed entries become -1
        sentinels in the logical page list (the table hands the kernel the
        trash page 0 for them; the window mask keeps those rows out)."""
        bound = self._kv_bound(seq_id)
        if bound is None:
            return
        ps = self.page_size
        pages = self.seq_pages[seq_id]
        j = self.seq_released[seq_id]
        # page j holds tokens [j*ps, (j+1)*ps); releasable when its newest
        # token is below len - bound with one token of slack (the kernel
        # sees lengths+1 during decode)
        while j < len(pages) and (j + 1) * ps <= self.seq_len[seq_id] - bound:
            if pages[j] >= 0:
                self._decref(pages[j])
                pages[j] = -1
            j += 1
        self.seq_released[seq_id] = j

    def _windows_arg(self, seq_ids):
        """[B] int32 per-request window limits (0 = no limit), or None when
        no active request sets one."""
        if not any(self.seq_window.get(s) for s in seq_ids):
            return None
        return torch.as_tensor(
            [self.seq_window.get(s) or 0 for s in seq_ids],
            dtype=torch.int32, device=self.device)

    # -- LoRA adapters and constraints -----------------------------------
    def _adapter_index(self, name) -> int:
        if name is None:
            return 0
        raise NotImplementedError(
            "LoRA adapters are supported on ModernBatchServer")

    def _lora_arg(self, seq_ids):
        """(adapter ids [B] int64, the stacked factors), or None when no
        adapter is registered or the batch is all base rows: the decode
        step then runs no gather and no delta."""
        if not self._adapters:
            return None
        host_ids = [self.seq_adapter.get(s, 0) for s in seq_ids]
        if not any(host_ids):
            return None
        return (torch.as_tensor(host_ids, dtype=torch.int64,
                                device=self.device), self._lora_stacks)

    def register_constraint(self, name: str, dfa) -> None:
        """Register a :class:`~lamp_tpu_torch.models.constrained.TokenDFA`
        under ``name`` for ``add(..., constraint=name)``. Its transition
        table is appended to the server's stacked device table once; a
        constrained batch then gathers one row a request a decode step,
        which masks the logits and gives the next state. Compile the DFA
        with ``eos_token`` so that every accepting state keeps an
        out-edge."""
        if name in self._constraints:
            raise ValueError(f"duplicate constraint {name!r}")
        if dfa.vocab_size != self.vocab:
            raise ValueError(f"constraint vocab {dfa.vocab_size} != model "
                             f"vocab {self.vocab}")
        offset = self._ctable_host.shape[0]
        block = dfa.table.astype(np.int32).copy()
        block[block >= 0] += offset
        self._constraints[name] = dfa
        self._c_offsets[name] = offset
        self._ctable_host = np.concatenate([self._ctable_host, block], 0)
        self._ctable_dev = torch.as_tensor(self._ctable_host,
                                           device=self.device)

    def _constraint_arrays(self, seq_ids):
        """(table, states [B]) for the batch, or (None, None) when no
        request in it is constrained: the step then gathers and masks
        nothing."""
        states = [self.seq_cstate.get(s, 0) for s in seq_ids]
        if not any(states):
            return None, None
        return self._ctable_dev, torch.as_tensor(states, dtype=torch.int64,
                                                 device=self.device)

    def _constraint_advance(self, seq_ids, toks_host) -> None:
        """The automata's host-side advance over the sampled tokens
        ``toks_host`` [n, B]. A state with no out-edge falls back to the
        free automaton."""
        for i, sid in enumerate(seq_ids):
            st = self.seq_cstate.get(sid, 0)
            if st == 0:
                continue
            for t in toks_host[:, i]:
                st = int(self._ctable_host[st, int(t)])
                if st < 0:
                    st = 0
                    break
            self.seq_cstate[sid] = st

    @property
    def active(self) -> List:
        return list(self.seq_pages)

    @property
    def available_pages(self) -> int:
        """Pages the allocator can hand out: free and cached (reclaimable)."""
        return len(self.free_pages) + len(self._lru)

    # -- internals ------------------------------------------------------
    def _alloc_slot(self, seq_id) -> Tuple[int, int]:
        pos = self.seq_len[seq_id]
        if pos >= self.model.context_length:
            # request lifecycle (max_tokens, stop tokens, context-edge
            # retirement) belongs to the caller: ServingEngine handles it
            raise RuntimeError(
                f"sequence {seq_id!r} is at context_length="
                f"{self.model.context_length}; remove() it (ServingEngine "
                "handles max_tokens/stop/context retirement automatically)")
        pages = self.seq_pages[seq_id]
        if pos % self.page_size == 0 and pos // self.page_size == len(pages):
            pg = self._take_page()
            self._page_refs[pg] = 1
            pages.append(pg)
        pg = pages[pos // self.page_size]
        if self._page_refs[pg] > 1:
            # about to write into a SHARED page (a fork's tail, or a rewind
            # into a cached prefix): copy-on-write
            new = self._take_page()
            self._page_refs[new] = 1
            self._copy_page(pg, new)
            self._decref(pg)
            pages[pos // self.page_size] = new
            pg = new
        elif pg in self._page_hash:
            # sole owner of a content-addressed page: the write changes its
            # content, so its cache entry goes
            self._invalidate_page(pg)
        return pg, pos % self.page_size

    def _views(self, seq_ids):
        """(page table [B, max_pages], lengths [B]) int32 on the device."""
        b = len(seq_ids)
        idx = np.zeros((b, self.max_pages_per_seq), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self.seq_pages[sid]
            idx[i, :len(pages)] = pages
            lens[i] = self.seq_len[sid]
        # released pages (-1 sentinels) point at the trash page 0: the
        # kernel's window mask keeps their tokens out of every softmax
        np.maximum(idx, 0, out=idx)
        return (torch.as_tensor(idx, device=self.device),
                torch.as_tensor(lens, device=self.device))

    def _require_capacity(self, seq_ids, n: int) -> None:
        """Pre-scan the batch BEFORE any page release / slot allocation /
        length bump, so the context-length error never leaves a step
        half-mutated."""
        ctx = self.model.context_length
        full = [s for s in seq_ids if self.seq_len[s] + n > ctx]
        if full:
            raise RuntimeError(
                f"sequences {full!r} would exceed context_length={ctx} "
                f"after {n} token(s); remove() them (ServingEngine handles "
                "max_tokens/stop/context retirement automatically)")

    def _advance(self, seq_ids, tokens):
        """Write tokens' KV + return logits [B, V] f32; bumps lengths."""
        self._require_capacity(seq_ids, 1)
        for s in seq_ids:
            self._release_pages(s)
        slots = [self._alloc_slot(s) for s in seq_ids]
        idx, lens = self._views(seq_ids)
        dev = self.device
        logits = self._decode_step(
            tokens, idx, lens,
            torch.as_tensor([p for p, _ in slots], device=dev),
            torch.as_tensor([sl for _, sl in slots], device=dev),
            self._windows_arg(seq_ids), self._lora_arg(seq_ids))
        for s in seq_ids:
            self.seq_len[s] += 1
        return logits

    def advance_chunk(self, seq_ids, tokens):
        """Process m tokens of each sequence in one call; returns logits
        [B, m, V] f32. Token j's logits predict token j+1 (causal within
        the chunk). Bumps lengths by m."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        self._require_capacity(seq_ids, tokens.shape[1])
        for s in seq_ids:
            self._release_pages(s)
        return self._run_chunk(seq_ids, tokens)

    def _run_chunk(self, seq_ids, tokens):
        """m slots a sequence of ``tokens`` [B, m], then one
        :meth:`_decode_chunk` call; returns its logits [B, m, V]."""
        b, m = tokens.shape
        lens0 = torch.as_tensor([self.seq_len[s] for s in seq_ids],
                                dtype=torch.int32, device=self.device)
        tp = np.zeros((b, m), np.int64)
        ts = np.zeros((b, m), np.int64)
        for i, s in enumerate(seq_ids):
            for j in range(m):
                tp[i, j], ts[i, j] = self._alloc_slot(s)
                self.seq_len[s] += 1
        # page table AFTER allocation (a chunk may open new pages)
        idx, _ = self._views(seq_ids)
        return self._decode_chunk(
            tokens, idx, lens0, torch.as_tensor(tp, device=self.device),
            torch.as_tensor(ts, device=self.device),
            self._windows_arg(seq_ids), self._lora_arg(seq_ids))

    def rewind(self, seq_id, n: int) -> None:
        """Drop the last ``n`` tokens' KV (speculative-decoding rollback).
        The rows are simply forgotten: lengths mask them and their slots are
        reused on the next advance; pages past the new length go back to
        the pool (a decref under the prefix cache, and the next write into
        a page still shared copies it)."""
        if not 0 <= n <= self.seq_len[seq_id]:
            raise ValueError(
                f"rewind({n}) of {seq_id!r}, which holds "
                f"{self.seq_len[seq_id]} tokens")
        self.seq_len[seq_id] -= n
        rel = self.seq_released.get(seq_id, 0)
        if rel:
            bound = self._kv_bound(seq_id)
            # the rewound band must not re-enter released history
            if bound is None or \
                    self.seq_len[seq_id] + 1 - bound < rel * self.page_size:
                raise RuntimeError(
                    f"rewind({n}) crosses KV already released by the "
                    f"sliding window for {seq_id!r}")
        keep = max(-(-self.seq_len[seq_id] // self.page_size), rel)
        pages = self.seq_pages[seq_id]
        while len(pages) > keep:
            self._decref(pages.pop())

    def _sampling_arrays(self, seq_ids):
        """(temperature [B] | None, top_k [B] | None, top_p [B] | None,
        min_p [B] | None, penalties | None, max_top_k, want_logprobs). A
        filter is None when no request uses it; temperature is None when
        the whole batch is greedy (a bare argmax, no random draws);
        penalties, when a request has any, is (counts [B, V], prompt mask
        [B, V], presence [B], frequency [B], repetition [B])."""
        ps = [self.seq_params[s] for s in seq_ids]
        dev = self.device

        def col(values, dtype):
            return torch.as_tensor(values, dtype=dtype, device=dev)

        temps = None
        if any(p.temperature > 0 for p in ps):
            temps = col([p.temperature for p in ps], torch.float32)
        top_k, max_top_k = None, 0
        if any(p.top_k > 0 for p in ps):
            top_k = col([p.top_k for p in ps], torch.int64)
            mk = max(p.top_k for p in ps)
            if mk > NUCLEUS_CAND:
                max_top_k = 1 << (mk - 1).bit_length()
        top_p = None
        if any(p.top_p < 1.0 for p in ps):
            top_p = col([p.top_p for p in ps], torch.float32)
        min_p = None
        if any(p.min_p > 0.0 for p in ps):
            min_p = col([p.min_p for p in ps], torch.float32)
        penalties = None
        if any(p.has_penalties for p in ps):
            counts, pmask = self._pen_stacks(seq_ids)
            penalties = (
                counts, pmask,
                col([p.presence_penalty for p in ps], torch.float32),
                col([p.frequency_penalty for p in ps], torch.float32),
                col([p.repetition_penalty for p in ps], torch.float32))
        want_lp = any(p.logprobs for p in ps)
        return temps, top_k, top_p, min_p, penalties, max_top_k, want_lp

    def _pen_stacks(self, seq_ids):
        """Device [B, V] (counts, prompt mask) for the batch, cached per
        composition. On a change the surviving rows are gathered from the
        last stack and new or dirty rows start at zero, so a steady batch
        adds no work here."""
        key = tuple(seq_ids)
        cache = self._pen_cache
        if cache is not None and cache[0] == key and not self._pen_dirty:
            return cache[1], cache[2]
        zero = np.zeros(self.vocab, bool)
        pmask = torch.as_tensor(
            np.stack([self.seq_prompt_mask.get(s, zero) for s in seq_ids]),
            device=self.device)
        counts = torch.zeros((len(seq_ids), self.vocab), dtype=torch.int32,
                             device=self.device)
        if cache is not None:
            old_ids, old_counts, _ = cache
            pos = {s: i for i, s in enumerate(old_ids)}
            keep = [(i, pos[s]) for i, s in enumerate(seq_ids)
                    if s in pos and s not in self._pen_dirty]
            if keep:
                rows = torch.as_tensor([i for i, _ in keep],
                                       device=self.device)
                srcs = torch.as_tensor([j for _, j in keep],
                                       device=self.device)
                counts[rows] = old_counts[srcs]
        self._pen_dirty.clear()
        self._pen_cache = (key, counts, pmask)
        return counts, pmask

    def _sample(self, logits, arrays, rows=None):
        """One token a row of ``logits`` under ``arrays``
        (:meth:`_sampling_arrays`) and the constraint rows ``rows``;
        returns (tokens, logprobs | None). The caller bumps the penalty
        counts after."""
        temps, top_k, top_p, min_p, pen, mtk, want_lp = arrays
        out = sample_tokens(logits, self.generator, temps, top_k, top_p,
                            penalties=pen, allowed_rows=rows, min_p=min_p,
                            max_top_k=mtk, return_logprobs=want_lp)
        return out if want_lp else (out, None)

    def _record(self, seq_ids, toks_host, lps_host) -> Dict:
        """Host bookkeeping after sampling: toks_host/lps_host are [n, B]."""
        if lps_host is not None:
            for i, sid in enumerate(seq_ids):
                if sid in self.seq_logprobs:
                    self.seq_logprobs[sid].extend(
                        float(x) for x in lps_host[:, i])
        out = {}
        for i, s in enumerate(seq_ids):
            seq_toks = [int(t) for t in toks_host[:, i]]
            self.last_token[s] = seq_toks[-1]
            out[s] = seq_toks
        return out

    # -- decode ----------------------------------------------------------
    def step(self) -> Dict:
        """Decode one token for every active request; returns {seq_id:
        token}."""
        seq_ids = self.active
        if not seq_ids:
            return {}
        tokens = torch.as_tensor([self.last_token[s] for s in seq_ids],
                                 device=self.device)
        logits = self._advance(seq_ids, tokens)
        arrays = self._sampling_arrays(seq_ids)
        ctable, cstates = self._constraint_arrays(seq_ids)
        rows = None if ctable is None else ctable[cstates]
        nxt, lps = self._sample(logits, arrays, rows)
        # ONE device->host copy for the whole batch
        nxt_host = nxt.cpu().numpy()[None]
        if ctable is not None:
            self._constraint_advance(seq_ids, nxt_host)
        if arrays[4] is not None:
            _bump_counts(arrays[4][0], nxt)
        out = self._record(seq_ids, nxt_host,
                           None if lps is None else lps.cpu().numpy()[None])
        return {s: t[0] for s, t in out.items()}

    def step_many(self, n: int) -> Dict:
        """Decode ``n`` tokens for every active request; returns {seq_id:
        [tok, ...]}. All n slots are allocated up front (and pages released
        once), then n decode steps run back to back with sampling on the
        device, each step's tokens feeding the next (and, on the device,
        the penalty counts and the constraint states); one device->host
        copy at the end. No request joins or leaves between the n steps."""
        seq_ids = self.active
        if not seq_ids:
            return {}
        b = len(seq_ids)
        self._require_capacity(seq_ids, n)
        for s in seq_ids:
            self._release_pages(s)
        lens0 = torch.as_tensor([self.seq_len[s] for s in seq_ids],
                                dtype=torch.int32, device=self.device)
        tok = torch.as_tensor([self.last_token[s] for s in seq_ids],
                              device=self.device)
        tp = np.zeros((b, n), np.int64)
        ts = np.zeros((b, n), np.int64)
        for i, s in enumerate(seq_ids):
            for j in range(n):
                tp[i, j], ts[i, j] = self._alloc_slot(s)
                self.seq_len[s] += 1
        # page table AFTER allocation (later steps may open new pages; the
        # per-step live length keeps unwritten slots out of attention)
        idx, _ = self._views(seq_ids)
        tp = torch.as_tensor(tp, device=self.device)
        ts = torch.as_tensor(ts, device=self.device)
        windows = self._windows_arg(seq_ids)
        lora = self._lora_arg(seq_ids)
        arrays = self._sampling_arrays(seq_ids)
        ctable, cst = self._constraint_arrays(seq_ids)
        toks, lps = [], []
        for i in range(n):
            logits = self._decode_step(tok, idx, lens0 + i, tp[:, i],
                                       ts[:, i], windows, lora)
            # a constrained batch's rows are its mask and its next states
            rows = None if cst is None else ctable[cst]
            tok, lp = self._sample(logits, arrays, rows)
            if cst is not None:
                # the dead-end guard of _constraint_advance: a state with
                # no out-edge falls back to the free automaton
                cst = rows.gather(1, tok[:, None])[:, 0].clamp_min(0).long()
            if arrays[4] is not None:
                _bump_counts(arrays[4][0], tok)
            toks.append(tok)
            lps.append(lp)
        toks_host = torch.stack(toks).cpu().numpy()  # [n, B]
        lps_host = (None if lps[0] is None
                    else torch.stack(lps).cpu().numpy())
        if ctable is not None:
            self._constraint_advance(seq_ids, toks_host)
        return self._record(seq_ids, toks_host, lps_host)

    # -- the GPT model hooks ----------------------------------------------
    def _precompute_extras(self, model):
        """Decode-path weights of the GPT: a fused [(3·H·hd), D] QKV weight
        a layer, its fused bias (zeros for a linear without one; None when
        no linear has one), and an f32 copy of the tied embedding for the
        logits, so that they accumulate and stay in f32 as the JAX server's
        ``preferred_element_type`` does."""
        if self.quantize_bits:
            raise ValueError(
                "quantize_bits is supported on ModernBatchServer")
        ws, bs = [], []
        any_bias = False
        with torch.no_grad():
            for block in model.encoder.blocks:
                att = block.attention
                lins = (att.w_q, att.w_k, att.w_v)
                ws.append(torch.cat([lin.weight for lin in lins]))
                row = []
                for lin in lins:
                    if lin.bias is not None:
                        any_bias = True
                        row.append(lin.bias)
                    else:
                        row.append(torch.zeros_like(lin.weight[:, 0]))
                bs.append(torch.cat(row))
            lmh = model.token_embedding.weight.detach().float()
        return tuple(ws), (tuple(bs) if any_bias else None), lmh

    @staticmethod
    def _project(x, weight, bias):
        """``x`` times ``weight`` [out, in], the product rounded to x's dtype
        before ``bias`` is added (the JAX server's order; ``F.linear``
        would add it before rounding)."""
        y = F.linear(x, weight)
        return y if bias is None else y + bias

    @staticmethod
    def _mlp_residual(x, block):
        """x plus the pre-norm block's MLP, w2(activation(w1(norm2(x)))),
        times its learned scale."""
        return x + block.w2(block.activation(block.w1(block.norm2(x)))) \
            * block.scale2

    @torch.no_grad()
    def _prefill_seq(self, tokens, token_pages, token_slots, req_window=None):
        """Dense prefill of ONE sequence: causal forward over its [T] tokens
        at learned positions 0..T-1 with the plain attention, writing every
        layer's K/V rows into (token_pages, token_slots). ``req_window`` is
        this request's window. (The JAX server pads T to a bucket to bound
        its jit traces; causal attention makes the padding inert, so it is
        left out here.)"""
        model = self.model
        t = tokens.shape[0]
        x = model.token_embedding(tokens[None]) + \
            model.position_embedding.weight[:t][None]  # [1, T, D]
        h, hd = self.heads, self.head_dim
        deferred_rows = []
        for block in model.encoder.blocks:
            att = block.attention
            a = block.norm1(x)

            def heads(lin):
                return self._project(a, lin.weight, lin.bias).reshape(
                    1, t, h, hd).transpose(1, 2)

            q, kk, vv = heads(att.w_q), heads(att.w_k), heads(att.w_v)
            deferred_rows.append((kk[0].transpose(0, 1).reshape(t, -1),
                                  vv[0].transpose(0, 1).reshape(t, -1)))
            o = mha_reference(q, kk, vv, causal=True, window=req_window)
            o = o.transpose(1, 2).reshape(1, t, h * hd)
            x = x + self._project(o, att.w_o.weight, att.w_o.bias) \
                * block.scale1
            x = self._mlp_residual(x, block)
        _kv_write_stacked(self.kv_pages, self.total_pages, token_pages,
                          token_slots, deferred_rows)

    @torch.no_grad()
    def _decode_step(self, tokens, page_idx, lengths, token_pages,
                     token_slots, req_windows=None, lora=None):
        """Process a [B] batch of tokens sitting at positions ``lengths``:
        attend over history + self, write every layer's K/V into
        (token_pages, token_slots) of the pool, return logits [B, V] f32.
        The GPT takes no adapter: ``lora`` is always None here."""
        self.steps_decoded += 1
        model = self.model
        b = tokens.shape[0]
        wqkv, bqkv, lmh = self._extras
        x = model.token_embedding(tokens) + \
            model.position_embedding.weight[lengths]  # [B, D]
        nq = self.heads * self.head_dim
        deferred_rows = []  # per-layer (k_rows, v_rows) written after loop
        for li, block in enumerate(model.encoder.blocks):
            att = block.attention
            y = self._project(block.norm1(x), wqkv[li],
                              None if bqkv is None else bqkv[li])
            q = y[:, :nq].reshape(b, self.heads, self.head_dim)
            kk, vv = y[:, nq:2 * nq], y[:, 2 * nq:]
            # the current token's K/V is INJECTED into the kernel
            # (append_kv), so the pool write is deferred out of the loop
            deferred_rows.append((kk, vv))
            o = paged_attention(
                q, self.kv_pages, None, page_idx, lengths,
                num_kv_heads=self.kv_heads, windows=req_windows,
                append_kv=(kk, vv), page_offset=li * self.total_pages,
            ).reshape(b, nq)
            x = x + self._project(o, att.w_o.weight, att.w_o.bias) \
                * block.scale1
            x = self._mlp_residual(x, block)
        _kv_write_stacked(self.kv_pages, self.total_pages, token_pages,
                          token_slots, deferred_rows)
        return F.linear(model.final_norm(x).float(), lmh)

    @torch.no_grad()
    def _decode_chunk(self, tokens, page_idx, lengths, token_pages,
                      token_slots, req_windows=None, lora=None):
        """Process a [B, m] chunk of tokens at positions ``lengths[:, None]
        + arange(m)``: each layer writes the chunk's K/V rows into
        (token_pages, token_slots) [B, m] of the pool before its attention,
        then the paged kernel attends over the B*m query rows (the page
        table repeated m times, lengths pos + 1); returns logits [B, m, V]
        f32. The GPT takes no adapter: ``lora`` is always None here."""
        model = self.model
        b, m = tokens.shape
        wqkv, bqkv, lmh = self._extras
        pos = lengths.long()[:, None] + \
            torch.arange(m, device=self.device)[None]
        x = model.token_embedding(tokens) + \
            model.position_embedding.weight[pos]  # [B, m, D]
        nq = self.heads * self.head_dim
        plen = (pos + 1).reshape(-1).to(torch.int32)
        pidx = page_idx.repeat_interleave(m, dim=0)
        win_r = (None if req_windows is None
                 else req_windows.repeat_interleave(m))
        tp = token_pages.reshape(-1)
        ts = token_slots.reshape(-1)
        for li, block in enumerate(model.encoder.blocks):
            att = block.attention
            y = self._project(block.norm1(x), wqkv[li],
                              None if bqkv is None else bqkv[li])
            _kv_write_stacked(self.kv_pages, self.total_pages,
                              tp + li * self.total_pages, ts,
                              [(y[..., nq:2 * nq].reshape(b * m, nq),
                                y[..., 2 * nq:].reshape(b * m, nq))])
            o = paged_attention(
                y[..., :nq].reshape(b * m, self.heads, self.head_dim),
                self.kv_pages, None, pidx, plen,
                num_kv_heads=self.kv_heads, windows=win_r,
                page_offset=li * self.total_pages,
            ).reshape(b, m, nq)
            x = x + self._project(o, att.w_o.weight, att.w_o.bias) \
                * block.scale1
            x = self._mlp_residual(x, block)
        return F.linear(model.final_norm(x).float(), lmh)


class ModernBatchServer(BatchServer):
    """Paged-KV batch decode for :class:`lamp_tpu_torch.nn.ModernLM` (RoPE +
    GQA + RMSNorm + SwiGLU). The pool holds ``num_kv_heads`` fused head rows;
    RoPE rotates q/k at each token's absolute position before the pages are
    written, so the cached keys are already position-encoded."""

    def __init__(self, model, *, mesh=None, **kwargs):
        # SwiGLUMoE blocks decode by dense dispatch; they take int8 experts,
        # and neither int4 nor adapters, as in JAX
        self._moe = any(isinstance(b.mlp, SwiGLUMoE) for b in model.blocks)
        if self._moe:
            self._moe_top_k = int(model.blocks[0].mlp.top_k)
            if kwargs.get("quantize_bits") == 4:
                raise NotImplementedError(
                    "int4 quantization with MoE serving (int8 is supported)")
        if mesh is not None:
            raise NotImplementedError("mesh= (tensor-parallel serving)")
        biased = sorted({name for b in model.blocks
                         for name in ("w_q", "w_k", "w_v", "w_o")
                         if getattr(b, name).bias is not None})
        if biased:
            raise NotImplementedError(
                f"attention biases ({', '.join(biased)}): the decode step "
                "and the prefill multiply by the weights alone, as the JAX "
                "server's do, and would serve other tokens than the model's")
        super().__init__(model, **kwargs)
        # per adapter, per layer: {projection: (A [in, r], B [r, out])}
        self._adapter_defs: Dict[str, List[dict]] = {}

    def _introspect(self, model):
        block = model.blocks[0]
        self.layers = len(model.blocks)
        self.heads = block.num_heads
        self.kv_heads = block.num_kv_heads
        self.head_dim = block.w_q.weight.shape[1] // self.heads
        # per-layer sliding windows: the kernel walks only each layer's band
        self._windows = tuple(b.window for b in model.blocks)

    # -- multi-LoRA serving ------------------------------------------------
    def _adapter_index(self, name) -> int:
        if name is None:
            return 0
        try:
            return self._adapters[name]
        except KeyError:
            raise ValueError(f"unknown adapter {name!r}") from None

    @staticmethod
    def _projections(blk):
        return {"q": blk.w_q, "k": blk.w_k, "v": blk.w_v, "o": blk.w_o,
                "w1": blk.mlp.w1, "w3": blk.mlp.w3, "w2": blk.mlp.w2}

    def register_adapter(self, name: str, lora_model) -> None:
        """Register a LoRA adapter for per-request use: ``lora_model`` is a
        :func:`~lamp_tpu_torch.nn.lora_inject`-ed copy of this server's
        model. Requests pass ``add(..., adapter=name)``, and one batch
        mixes adapters freely: the decode step gathers each row's A and B
        factors from the stacked adapters and adds the low-rank delta
        beside the shared base matmuls. The prefix cache is partitioned by
        adapter. Only the blocks' q/k/v/o/w1/w3/w2 projections can be
        served: an adapter on any other module (an untied ``lm_head``)
        raises ``ValueError``."""
        if self._moe:
            raise NotImplementedError("adapters on MoE models")
        if name in self._adapters:
            raise ValueError(f"duplicate adapter {name!r}")
        per_layer = []
        n_collected = 0
        with torch.no_grad():
            for blk in lora_model.blocks:
                row = {}
                for p, mod in self._projections(blk).items():
                    if type(mod) is LoRALinear:
                        # scale folded into B in f32, back in B's dtype
                        row[p] = (mod.lora_a.detach(),
                                  (mod.lora_b.float() * mod.scale
                                   ).to(mod.lora_b.dtype))
                        n_collected += 1
                per_layer.append(row)
        n_total = sum(type(m) is LoRALinear for m in lora_model.modules())
        if n_total != n_collected:
            raise ValueError(
                f"adapter {name!r} adapts {n_total - n_collected} module(s) "
                "outside the block q/k/v/o/w1/w3/w2 projections (an untied "
                "lm_head or embedding); these are not servable: restrict "
                "lora_inject's match= accordingly")
        self._adapter_defs[name] = per_layer
        self._adapters[name] = len(self._adapters) + 1  # 0 = the base
        self._rebuild_lora_stacks()

    def _rebuild_lora_stacks(self) -> None:
        """Stack every adapter's factors: per adapted projection p and
        layer, A [N+1, d_in, r_p] and B [N+1, r_p, d_out]; index 0 is the
        all-zero base, smaller ranks are zero-padded to r_p, and an
        adapter that leaves p alone has zero rows."""
        n = len(self._adapters)
        order = sorted(self._adapters, key=self._adapters.get)
        shapes = {p: m.weight.shape for p, m in
                  self._projections(self.model.blocks[0]).items()}
        dt = self.model.blocks[0].w_q.weight.dtype
        stacks = {}
        for p, (d_out, d_in) in shapes.items():
            ranks = [self._adapter_defs[nm][li][p][0].shape[1]
                     for nm in order for li in range(self.layers)
                     if p in self._adapter_defs[nm][li]]
            if not ranks:
                continue
            r = max(ranks)
            a_layers, b_layers = [], []
            for li in range(self.layers):
                a_rows = torch.zeros((n + 1, d_in, r), dtype=dt,
                                     device=self.device)
                b_rows = torch.zeros((n + 1, r, d_out), dtype=dt,
                                     device=self.device)
                for k, nm in enumerate(order):
                    entry = self._adapter_defs[nm][li].get(p)
                    if entry is None:
                        continue
                    a, bv = entry
                    a_rows[k + 1, :, :a.shape[1]] = a.to(dt)
                    b_rows[k + 1, :bv.shape[0], :] = bv.to(dt)
                a_layers.append(a_rows)
                b_layers.append(b_rows)
            stacks[p] = (tuple(a_layers), tuple(b_layers))
        self._lora_stacks = stacks

    @staticmethod
    def _lora_delta(x, stack, ids, li):
        """Each row's low-rank delta: x [B, D_in] or [B, T, D_in]; layer
        ``li`` of ``stack`` holds A [N+1, D_in, r] and B [N+1, r, O] (the
        scale folded into B), ``ids`` [B] the rows' adapters. Two
        ``torch.bmm`` (products summed in f32, each rounded to x's dtype,
        as the JAX einsums with ``preferred_element_type=f32``); returns
        x's shape with O columns."""
        a_stack, b_stack = stack
        x3 = x if x.dim() == 3 else x[:, None]
        h = torch.bmm(x3, a_stack[li].index_select(0, ids))
        out = torch.bmm(h, b_stack[li].index_select(0, ids))
        return out if x.dim() == 3 else out[:, 0]

    def _plus_delta(self, y, x, lora, p, li):
        """``y`` plus projection ``p``'s delta of ``x`` where the batch
        carries adapters that adapt ``p``; else ``y`` itself."""
        if lora is None or p not in lora[1]:
            return y
        ids, stacks = lora
        return y + self._lora_delta(x, stacks[p], ids, li)

    def _quantize_weight(self, w):
        """Decode-path entry of a weight ``w`` [out, in]: ``w`` itself, or,
        under ``quantize_bits``, a (values, scales) pair in the JAX layout of
        its transpose [in, out]: nibble-packed int4 with per-group scales,
        or int8 with per-channel scales."""
        if not self.quantize_bits:
            return w
        wt = w.detach().T
        if self.quantize_bits == 8:
            return quantize_int8(wt, axis=0)
        return quantize_int4(wt, group_size=int4_group_size(wt.shape[0]))

    @staticmethod
    def _mm(a, w, out_dtype=None):
        """``a`` times a decode-path entry (see :meth:`_quantize_weight`):
        a float [out, in] weight through ``F.linear`` (``a`` cast to its
        dtype), or a packed pair through :func:`int4_matmul` or
        :func:`int8_matmul`. The result is in ``out_dtype`` (default: the
        product's)."""
        if isinstance(w, tuple):
            vals, scales = w
            fn = int4_matmul if vals.dtype == torch.uint8 else int8_matmul
            return fn(a, vals, scales, out_dtype=out_dtype)
        y = F.linear(a.to(w.dtype), w)
        return y if out_dtype is None else y.to(out_dtype)

    def _quantize_stacked(self, w13, w2):
        """Decode-path entries of one MoE layer's stacked experts, w1 and
        w3 (``w13``, two [E, D, H]) and w2 [E, H, D]: the tensors
        themselves, or under ``quantize_bits=8`` int8 per expert per output
        channel, as the JAX server's ``_quantize_stacked`` (values and
        scales [E, 1, N] the same), laid out for ``torch._int_mm``: w1 and
        w3 as one [D, 2 E H] matrix of their columns (w1's experts, then
        w3's) with its [1, 2 E H] scales, so that one product gives every
        expert's gate and up rows; w2 as it is."""
        if not self.quantize_bits:
            return w13, w2
        d = w2.shape[2]
        parts = [quantize_int8(w.detach(), axis=1) for w in w13]
        v13 = torch.cat([v.permute(1, 0, 2).reshape(d, -1)
                         for v, _ in parts], dim=1)
        s13 = torch.cat([sc.reshape(1, -1) for _, sc in parts], dim=1)
        return (v13, s13), quantize_int8(w2.detach(), axis=1)

    def _moe_mlp_rows(self, h, w13, w2, w_gate):
        """A MoE layer's MLP over the step's rows h [..., D], by dense
        dispatch (every expert computes every row, combined by the
        renormalized top-k gates; at decode's few rows a per-token gather
        of expert weights would move more bytes than computing all
        experts), as the JAX server's ``_moe_mlp_rows``. Under int8 the
        rows are quantized once (per row), the gate and up products of all
        experts are one ``torch._int_mm``, their SwiGLU activations are
        re-quantized per expert and row, and each expert's down product is
        one more; the scales apply to the int32 sums in JAX's order."""
        shape = h.shape
        flat = h.reshape(-1, shape[-1])
        if not isinstance(w2, tuple):
            y = swiglu_moe_dense(flat, w_gate, *w13, w2, self._moe_top_k)
            return y.reshape(shape).to(h.dtype)
        (v13, s13), (v2, s2) = w13, w2
        e, hid, _ = v2.shape
        combine = moe_combine(flat, w_gate, self._moe_top_k)
        xq, x_scale = quantize_int8(flat, axis=1)          # [T, D], [T, 1]
        g13 = (int_mm(xq, v13).float() * x_scale * s13
               ).reshape(-1, 2, e, hid)
        g = F.silu(g13[:, 0]) * g13[:, 1]                  # [T, E, H] f32
        gq, g_scale = quantize_int8(g, axis=2)             # per expert, row
        out = torch.stack([int_mm(gq[:, i].contiguous(), v2[i]).float()
                           * g_scale[:, i] * s2[i] for i in range(e)])
        y = torch.einsum("te,etd->td", combine, out.to(combine.dtype))
        return y.reshape(shape).to(h.dtype)

    def _mlp_rows(self, h, li, lora):
        """Layer ``li``'s MLP over the step's rows: the MoE's by dense
        dispatch, else the SwiGLU of the decode-path matrices with each
        row's adapter delta."""
        _, _, w1, w3, w2, _ = self._extras
        if self._moe:
            return self._moe_mlp_rows(h, w3[li], w2[li], w1[li])
        mm, delta = self._mm, self._plus_delta
        gate = (F.silu(delta(mm(h, w1[li]), h, lora, "w1", li))
                * delta(mm(h, w3[li]), h, lora, "w3", li))
        return delta(mm(gate, w2[li]), gate, lora, "w2", li)

    def _precompute_extras(self, model):
        """Decode-path weights: fused per-layer QKV, attention
        out-projection, the three SwiGLU matrices and the logits matrix,
        each through :meth:`_quantize_weight`. A MoE layer's entries are
        its gate [D, E] (in ``w1``'s place, never quantized), its w1 and
        w3 experts (in ``w3``'s) and its w2 experts, the last two through
        :meth:`_quantize_stacked`. Unquantized, the logits
        matrix is kept in f32 (a copy for bf16 models), so that logits
        accumulate and stay in f32 as the JAX server's
        ``preferred_element_type`` does; quantized, it is packed from the
        float weight (the tied embedding's transpose [D, V]) and its
        product written in f32."""
        q = self._quantize_weight
        with torch.no_grad():
            wqkv = tuple(q(torch.cat([blk.w_q.weight, blk.w_k.weight,
                                      blk.w_v.weight]))
                         for blk in model.blocks)
        wo = tuple(q(blk.w_o.weight) for blk in model.blocks)
        if self._moe:
            w1 = tuple(blk.mlp.w_gate for blk in model.blocks)
            w3, w2 = zip(*(self._quantize_stacked(
                (blk.mlp.w1, blk.mlp.w3), blk.mlp.w2)
                for blk in model.blocks))
        else:
            w1 = tuple(q(blk.mlp.w1.weight) for blk in model.blocks)
            w3 = tuple(q(blk.mlp.w3.weight) for blk in model.blocks)
            w2 = tuple(q(blk.mlp.w2.weight) for blk in model.blocks)
        if self.quantize_bits:
            lmh = q(model.output_weight)
        else:
            lmh = model.output_weight.detach().float()
        return (wqkv, wo, w1, w3, w2, lmh)

    @torch.no_grad()
    def _decode_step(self, tokens, page_idx, lengths, token_pages,
                     token_slots, req_windows=None, lora=None):
        """Process a [B] batch of tokens sitting at positions ``lengths``:
        attend over history + self, write every layer's K/V into
        (token_pages, token_slots) of the pool, return logits [B, V] f32.
        ``lora`` (:meth:`_lora_arg`) adds each row's adapter delta to
        q/k/v (before RoPE), o, w1 and w3 (before the gate) and w2."""
        self.steps_decoded += 1
        model = self.model
        b = tokens.shape[0]
        wqkv, wo, _, _, _, lmh = self._extras
        x = model.token_embedding(tokens)  # [B, D]
        # the RoPE angle gathers are shared by every layer
        hd = self.head_dim
        c = model.rope_cos[lengths].float()[:, None, :]  # [B, 1, hd/2]
        s = model.rope_sin[lengths].float()[:, None, :]

        def rot(t):
            t1, t2 = t.float().chunk(2, dim=-1)
            return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s],
                             dim=-1).to(t.dtype)

        nq = self.heads * hd
        nkv = self.kv_heads * hd
        mm = self._mm
        delta = self._plus_delta
        deferred_rows = []  # per-layer (k_rows, v_rows) written after loop
        for li, block in enumerate(model.blocks):
            a = block.norm1(x)
            y = mm(a, wqkv[li])
            yq = delta(y[:, :nq], a, lora, "q", li)
            yk = delta(y[:, nq:nq + nkv], a, lora, "k", li)
            q = rot(yq.reshape(b, self.heads, hd))
            kk_f = rot(yk.reshape(b, self.kv_heads, hd)).reshape(b, nkv)
            vv_f = delta(y[:, nq + nkv:], a, lora, "v", li).contiguous()
            # the current token's K/V is INJECTED into the kernel
            # (append_kv), so the pool write is deferred out of the loop
            deferred_rows.append((kk_f, vv_f))
            o = paged_attention(
                q, self.kv_pages, None, page_idx, lengths,
                num_kv_heads=self.kv_heads,
                window=self._windows[li], windows=req_windows,
                append_kv=(kk_f, vv_f),
                page_offset=li * self.total_pages,
            ).reshape(b, nq)
            x = x + delta(mm(o, wo[li]), o, lora, "o", li)
            x = x + self._mlp_rows(block.norm2(x), li, lora)
        _kv_write_stacked(self.kv_pages, self.total_pages, token_pages,
                          token_slots, deferred_rows)
        return mm(model.final_norm(x), lmh, out_dtype=torch.float32)

    @torch.no_grad()
    def _decode_chunk(self, tokens, page_idx, lengths, token_pages,
                      token_slots, req_windows=None, lora=None):
        """Process a [B, m] chunk of tokens at positions ``lengths[:, None]
        + arange(m)``: each layer writes the chunk's K/V rows into
        (token_pages, token_slots) [B, m] of the pool before its attention
        (row j of a chunk sees rows < j, which ``append_kv``'s one injected
        row cannot give), then the paged kernel attends over the B*m query
        rows (the page table repeated m times, lengths pos + 1); returns
        logits [B, m, V] f32. ``lora`` as in :meth:`_decode_step`."""
        model = self.model
        b, m = tokens.shape
        wqkv, wo, _, _, _, lmh = self._extras
        dev = self.device
        pos = lengths.long()[:, None] + torch.arange(m, device=dev)[None]
        x = model.token_embedding(tokens)  # [B, m, D]
        hd = self.head_dim
        c = model.rope_cos[pos].float()[:, :, None, :]  # [B, m, 1, hd/2]
        s = model.rope_sin[pos].float()[:, :, None, :]

        def rot(t):
            t1, t2 = t.float().chunk(2, dim=-1)
            return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s],
                             dim=-1).to(t.dtype)

        nq = self.heads * hd
        nkv = self.kv_heads * hd
        mm = self._mm
        delta = self._plus_delta
        plen = (pos + 1).reshape(-1).to(torch.int32)
        pidx = page_idx.repeat_interleave(m, dim=0)
        win_r = (None if req_windows is None
                 else req_windows.repeat_interleave(m))
        tp = token_pages.reshape(-1)
        ts = token_slots.reshape(-1)
        for li, block in enumerate(model.blocks):
            a = block.norm1(x)
            y = mm(a, wqkv[li])
            q = rot(delta(y[..., :nq], a, lora, "q", li
                          ).reshape(b, m, self.heads, hd))
            kk = rot(delta(y[..., nq:nq + nkv], a, lora, "k", li
                           ).reshape(b, m, self.kv_heads, hd))
            vv = delta(y[..., nq + nkv:], a, lora, "v", li)
            _kv_write_stacked(self.kv_pages, self.total_pages,
                              tp + li * self.total_pages, ts,
                              [(kk.reshape(b * m, nkv),
                                vv.reshape(b * m, nkv))])
            o = paged_attention(
                q.reshape(b * m, self.heads, hd), self.kv_pages, None, pidx,
                plen, num_kv_heads=self.kv_heads, window=self._windows[li],
                windows=win_r, page_offset=li * self.total_pages,
            ).reshape(b, m, nq)
            x = x + delta(mm(o, wo[li]), o, lora, "o", li)
            x = x + self._mlp_rows(block.norm2(x), li, lora)
        return mm(model.final_norm(x), lmh, out_dtype=torch.float32)

    @torch.no_grad()
    def _prefill_seq(self, tokens, token_pages, token_slots, req_window=None):
        """Dense prefill of ONE sequence: causal forward over its [T] tokens
        with the plain attention, writing every layer's K/V rows into
        (token_pages, token_slots). ``req_window`` is this request's window.
        (The JAX server pads T to a bucket to bound its jit traces; causal
        attention makes the padding inert, so it is left out here.)"""
        model = self.model
        t = tokens.shape[0]
        x = model.token_embedding(tokens[None])  # [1, T, D]
        cos, sin = model.rope_cos, model.rope_sin
        hd = self.head_dim
        deferred_rows = []
        for li, block in enumerate(model.blocks):
            a = block.norm1(x)

            def heads(lin, nh):
                return F.linear(a, lin.weight).reshape(1, t, nh, hd
                                                       ).transpose(1, 2)

            q = apply_rope(heads(block.w_q, self.heads), cos, sin)
            kk = apply_rope(heads(block.w_k, self.kv_heads), cos, sin)
            vv = heads(block.w_v, self.kv_heads)
            deferred_rows.append((kk[0].transpose(0, 1).reshape(t, -1),
                                  vv[0].transpose(0, 1).reshape(t, -1)))
            if self.kv_heads != self.heads:
                rep = self.heads // self.kv_heads
                kk = kk.repeat_interleave(rep, dim=1)
                vv = vv.repeat_interleave(rep, dim=1)
            w = self._windows[li]
            if req_window is not None:
                w = req_window if w is None else min(w, req_window)
            o = mha_reference(q, kk, vv, causal=True, window=w)
            x = x + F.linear(o.transpose(1, 2).reshape(1, t, -1),
                             block.w_o.weight)
            x = x + block.mlp(block.norm2(x))
        _kv_write_stacked(self.kv_pages, self.total_pages, token_pages,
                          token_slots, deferred_rows)


class _Fan:
    """An ``n`` / ``best_of`` request's branches while they run."""

    def __init__(self, n: int, ranked: bool, want_logprobs: bool, k: int):
        self.n = n                  # branches returned
        self.ranked = ranked        # best_of: rank by summed logprob
        self.want_logprobs = want_logprobs
        self.branches: List = [None] * k   # token lists as they finish
        self.logprobs: List = [None] * k

    def kept(self):
        """(the kept branches, their logprob lists), best first when
        ranked."""
        order = range(self.n)
        if self.ranked:
            order = sorted(range(len(self.branches)),
                           key=lambda i: -sum(self.logprobs[i]))[:self.n]
        kept = [self.branches[i] for i in order]
        kept_lp = [self.logprobs[i] for i in order]
        if self.n == 1:  # best_of with n=1 reads like a plain request
            return kept[0], kept_lp[0]
        return kept, kept_lp


class ServingEngine:
    """Continuous-batching scheduler over a :class:`BatchServer` (the GPT
    family) or a :class:`ModernBatchServer`.

    Requests are submitted with per-request :class:`SamplingParams`
    (temperature / top-k / top-p / penalties / ``max_tokens`` /
    ``stop_tokens``), an adapter and a constraint, and
    queue until KV pages are available; each :meth:`step` admits what fits
    (conservative worst-case page reservation, so the pool can never be
    exhausted mid-flight), decodes a chunk of tokens for the whole batch
    (``step_many``), applies stop conditions, and retires finished
    requests, freeing their pages for the queue.

    Usage:
        engine = ServingEngine(server, decode_steps=8)
        engine.submit(prompt, SamplingParams(max_tokens=64), request_id="a")
        results = engine.run()          # {"a": [tok, ...], ...}
    """

    def __init__(self, server: BatchServer, *, decode_steps: int = 8,
                 max_batch: int = 64, on_token=None):
        """``on_token(request_id, token)`` streams tokens as they are
        accepted (after stop and budget filtering): once per emitted token,
        in order, from :meth:`step`."""
        self.server = server
        self.decode_steps = decode_steps
        self.max_batch = max_batch
        self.on_token = on_token
        # (rid, prompt list, params, adapter, window, constraint)
        self.pending = deque()
        self.generated: Dict = {}    # rid -> [tokens so far]
        self.results: Dict = {}      # rid -> finished token list
        # chosen-token logprobs for requests with SamplingParams.logprobs,
        # aligned 1:1 with the emitted tokens (stop token excluded)
        self.result_logprobs: Dict = {}
        self._generated_lp: Dict = {}
        self._reserve: Dict = {}     # rid -> worst-case total pages
        self._max_new: Dict = {}     # rid -> decode budget
        self._next_id = 0
        self._retired = 0            # finished requests, fan-out branches too
        # n / best_of fan-out: branch rids are (parent, i)
        self._parent: Dict = {}      # branch rid -> parent rid
        self._fan: Dict = {}         # parent -> _Fan

    def submit(self, prompt_tokens, params: Optional[SamplingParams] = None,
               request_id=None, adapter: Optional[str] = None,
               window: Optional[int] = None,
               constraint: Optional[str] = None, n: int = 1,
               best_of: Optional[int] = None):
        """Queue a request; returns its id. Decoding starts once pages are
        available (see :meth:`step`). ``adapter`` selects a registered LoRA
        adapter; ``window`` caps the request's attention to its last
        ``window`` tokens; ``constraint`` names a DFA registered on the
        server with :meth:`BatchServer.register_constraint` (compile it
        with the request's EOS token and list that token in
        ``params.stop_tokens`` to stop on a complete match). An unknown
        adapter or constraint raises ``ValueError`` here (an adapter on the
        GPT server ``NotImplementedError``).

        ``n > 1`` fans the request into n independently sampled branches of
        one prompt (under the server's prefix cache they share the prompt's
        full pages): its result is then a list of n token lists (and
        ``result_logprobs`` a list of n logprob lists). ``best_of = k >= n``
        samples k branches and keeps the n of highest summed logprob, best
        first (``n == 1`` with ``best_of`` returns a plain token list: the
        best branch). Branch rids are ``(rid, i)``, as ``on_token`` sees
        them; they keep the request's adapter, constraint and penalties.
        Fan-out needs ``temperature > 0``."""
        rid = request_id if request_id is not None else f"req{self._next_id}"
        self._next_id += 1
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        ctx = self.server.model.context_length
        if len(prompt) > ctx:
            raise ValueError(
                f"prompt longer than context ({len(prompt)} > {ctx})")
        if params is None:
            # same default a direct server.add() would apply
            params = SamplingParams(temperature=self.server.temperature)
        self.server._adapter_index(adapter)  # validate early
        if window is not None and int(window) <= 0:
            raise ValueError("window must be a positive int")
        if constraint is not None and \
                constraint not in self.server._c_offsets:
            raise ValueError(f"unknown constraint {constraint!r}")
        if n < 1:
            raise ValueError("n must be >= 1")
        if best_of is not None and best_of < n:
            raise ValueError("best_of must be >= n")
        k = n if best_of is None else best_of
        if k > 1:
            if params.temperature == 0.0:
                raise ValueError(
                    "n/best_of > 1 requires temperature > 0 (greedy "
                    "branches would be identical)")
            ranked = best_of is not None
            self._fan[rid] = _Fan(n, ranked, params.logprobs, k)
            if ranked:
                # ranking reads each branch's logprobs; they reach the
                # result only where the caller asked for them
                params = dataclasses.replace(params, logprobs=True)
            for i in range(k):
                self._parent[(rid, i)] = rid
                self.pending.append(((rid, i), prompt, params, adapter,
                                     window, constraint))
            return rid
        self.pending.append((rid, prompt, params, adapter, window,
                             constraint))
        return rid

    def _budget(self, prompt_len: int, params: SamplingParams) -> int:
        """Decode-token budget for a request (stop at the context edge: the
        last processable position is context_length - 1)."""
        cap = self.server.model.context_length - prompt_len + 1
        if params.max_tokens is not None:
            cap = min(cap, params.max_tokens)
        return max(cap, 1)

    def _pages_for(self, prompt_len: int, max_new: int,
                   window: Optional[int] = None) -> int:
        # decode always runs full decode_steps chunks (tokens past a
        # request's budget are discarded), so reserve for max_new rounded
        # up to a chunk multiple; a sequence never holds more than
        # context_length rows
        ds = self.decode_steps
        ps = self.server.page_size
        chunks = -(-max_new // ds)
        total_rows = min(prompt_len - 1 + chunks * ds,
                         self.server.model.context_length)
        need = -(-max(total_rows, 1) // ps)
        bound = self.server.kv_bound_for(window)
        if bound is not None:
            # sliding-window release keeps concurrent pages O(bound): the
            # band plus one partially-retired page plus one chunk of
            # release lag. Prefill allocates the whole prompt before the
            # first release, so a long prompt's peak still has to fit.
            cap = -(-(bound + ps + ds) // ps) + 1
            prefill_pages = -(-max(prompt_len - 1, 1) // ps)
            need = min(need, max(cap, prefill_pages))
        return need

    def _held(self, rid) -> int:
        s = self.server
        return len(s.seq_pages[rid]) - s.seq_released.get(rid, 0)

    def _admit(self) -> None:
        s = self.server
        # pages still owed to requests already in flight
        owed = sum(self._reserve[r] - self._held(r) for r in s.seq_pages)
        while self.pending and len(s.seq_pages) < self.max_batch:
            rid, prompt, params, adapter, window, constraint = \
                self.pending[0]
            max_new = self._budget(len(prompt), params)
            need = self._pages_for(len(prompt), max_new, window)
            if s.available_pages < owed + need:
                break
            self.pending.popleft()
            s.add(rid, prompt, params, adapter=adapter, window=window,
                  constraint=constraint)
            self.generated[rid] = []
            if params.logprobs:
                self._generated_lp[rid] = []
            self._reserve[rid] = need
            self._max_new[rid] = max_new
            owed += need - self._held(rid)

    def step(self) -> Dict:
        """Admit + decode one chunk; returns {rid: tokens} for requests that
        FINISHED this step (stop token, max_tokens, or context edge)."""
        self._admit()
        s = self.server
        active = s.active
        if not active:
            return {}
        # full decode_steps chunks for the whole batch (tokens past a
        # request's budget are discarded — the reservation covers them);
        # only the hard context edge shrinks the chunk
        ctx = s.model.context_length
        n = max(min([self.decode_steps] + [ctx - s.seq_len[r] for r in active]),
                1)
        if n <= 1:
            chunk = {r: [t] for r, t in s.step().items()}
        else:
            chunk = s.step_many(n)
        finished = {}
        for rid, toks in chunk.items():
            g = self.generated[rid]
            params = s.seq_params[rid]
            lp_tail = (s.seq_logprobs[rid][-len(toks):]
                       if rid in self._generated_lp else None)
            done = False
            for i, t in enumerate(toks):
                if t in params.stop_tokens:
                    done = True
                    break  # stop token is not emitted
                g.append(t)
                if lp_tail is not None:
                    self._generated_lp[rid].append(lp_tail[i])
                if self.on_token is not None:
                    self.on_token(rid, t)
                if len(g) >= self._max_new[rid]:
                    done = True
                    break
            if done:
                finished[rid] = g
        out = {}
        for rid in finished:
            self._retire(rid)
            toks = self.generated.pop(rid)
            lp = self._generated_lp.pop(rid, None)
            parent = self._parent.pop(rid, None)
            if parent is None:
                self.results[rid] = toks
                if lp is not None:
                    self.result_logprobs[rid] = lp
                out[rid] = toks
                continue
            # a fan-out branch: the parent finishes, and is all that is
            # reported, once every branch is in
            fan = self._fan[parent]
            fan.branches[rid[1]] = toks
            fan.logprobs[rid[1]] = lp
            if any(b is None for b in fan.branches):
                continue
            del self._fan[parent]
            kept, kept_lp = fan.kept()
            out[parent] = self.results[parent] = kept
            if fan.want_logprobs:
                self.result_logprobs[parent] = kept_lp
        return out

    def _retire(self, rid) -> None:
        self.server.remove(rid)
        self._reserve.pop(rid)
        self._max_new.pop(rid)
        self._retired += 1

    def run(self) -> Dict:
        """Drain the queue; returns {rid: token list} for every request."""
        while self.pending or self.server.seq_pages:
            before = self._retired
            self.step()
            if self._retired == before and not self.server.seq_pages:
                raise RuntimeError(
                    "scheduler stalled: pending requests cannot be admitted "
                    "(page pool too small for the largest request)")
        return dict(self.results)

    def cancel(self, rid) -> bool:
        """Abort a request, pending or in flight. Its KV pages free
        immediately and it never appears in :attr:`results`. A fan-out
        parent cancels every branch. Returns False when the id is unknown
        or already finished."""
        fan = self._fan.pop(rid, None)
        if fan is not None:
            cancelled = False
            for i in range(len(fan.branches)):
                if self._parent.pop((rid, i), None) is not None:
                    cancelled |= self._cancel_leaf((rid, i))
            return cancelled
        self._parent.pop(rid, None)
        return self._cancel_leaf(rid)

    def _cancel_leaf(self, rid) -> bool:
        for i, entry in enumerate(self.pending):
            if entry[0] == rid:
                del self.pending[i]
                return True
        if rid in self.server.seq_pages:
            self._retire(rid)
            self.generated.pop(rid, None)
            self._generated_lp.pop(rid, None)
            return True
        return False


class BeamSearchDecoder:
    """Deterministic beam search over a paged server: every beam keeps
    paged KV, and a step is ONE batched decode over the live beams. A beam
    that branches forks (:meth:`BatchServer.fork`): the child shares the
    parent's pages, and the first write into the shared tail page copies
    it, so a fork never copies the KV history.

    Scoring: the summed logprob, divided in the final ranking by ``len **
    length_penalty`` (0: the plain sum, 1: the mean). ``early_stopping``
    stops once ``beams`` finished hypotheses exist; otherwise the search
    runs to ``max_tokens`` and unfinished beams compete with finished ones.

    Usage:
        server = ModernBatchServer(model, ..., enable_prefix_cache=True)
        hyps = BeamSearchDecoder(server, beams=4).decode(
            prompt, max_tokens=32, stop_tokens=(eos,))
        best_tokens, best_score = hyps[0]
    """

    def __init__(self, server: BatchServer, *, beams: int = 4,
                 length_penalty: float = 1.0, early_stopping: bool = True):
        if not server.enable_prefix_cache:
            raise ValueError(
                "BeamSearchDecoder needs a server with "
                "enable_prefix_cache=True (beam forks ride the refcount/COW "
                "machinery)")
        if beams < 1:
            raise ValueError("beams must be >= 1")
        self.server = server
        self.beams = beams
        self.length_penalty = length_penalty
        self.early_stopping = early_stopping
        self._n = 0

    def _score(self, cum: float, length: int) -> float:
        return cum / max(length, 1) ** self.length_penalty

    def decode(self, prompt_tokens, *, max_tokens: int,
               stop_tokens=()) -> List[Tuple[List[int], float]]:
        """Beam-search one prompt; returns up to ``beams`` hypotheses as
        ``(generated tokens, score)``, best first. Stop tokens are not
        emitted."""
        s = self.server
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        stop = set(int(t) for t in stop_tokens)
        w = self.beams
        tag = self._n
        self._n += 1
        root = ("_beam", tag, 0)
        s.add(root, prompt)
        live = [root]          # seq ids, one a live beam
        toks = {root: []}      # generated tokens of each live beam
        cums = {root: 0.0}     # summed logprob of each live beam
        done: List[Tuple[List[int], float]] = []
        next_child = 1
        max_steps = min(int(max_tokens),
                        s.model.context_length - len(prompt) + 1)
        for _ in range(max_steps):
            feed = torch.as_tensor([s.last_token[b] for b in live],
                                   device=s.device)
            logp = torch.log_softmax(s._advance(live, feed).float(), dim=-1)
            k = min(2 * w, logp.shape[-1])
            top_lp, top_ix = torch.topk(logp, k)
            top_lp = top_lp.cpu().numpy()
            top_ix = top_ix.cpu().numpy()
            cands = sorted(
                ((cums[b] + float(top_lp[i, j]), i, int(top_ix[i, j]))
                 for i, b in enumerate(live) for j in range(k)),
                key=lambda c: -c[0])
            chosen = []
            for score, i, t in cands:
                if t in stop:
                    b = live[i]
                    done.append((list(toks[b]),
                                 self._score(score, len(toks[b]) + 1)))
                elif len(chosen) < w:
                    chosen.append((score, i, t))
            if self.early_stopping and len(done) >= w:
                for b in live:
                    s.remove(b)
                live = []
                break
            # one child a parent continues in place, the others fork, all
            # before any state of the parent changes
            used = set()
            new_live, new_toks, new_cums = [], {}, {}
            for score, i, t in chosen:
                parent = live[i]
                if i not in used:
                    used.add(i)
                    bid = parent
                else:
                    bid = ("_beam", tag, next_child)
                    next_child += 1
                    s.fork(parent, bid)
                new_live.append(bid)
                new_toks[bid] = toks[parent] + [t]
                new_cums[bid] = score
            for i, b in enumerate(live):
                if i not in used:
                    s.remove(b)
            for bid, (_, _, t) in zip(new_live, chosen):
                s.last_token[bid] = t
            live, toks, cums = new_live, new_toks, new_cums
            if not live:  # every candidate finished
                break
        for b in live:  # out of budget: unfinished beams compete too
            done.append((list(toks[b]), self._score(cums[b], len(toks[b]))))
            s.remove(b)
        done.sort(key=lambda h: -h[1])
        return done[:w]


class SpeculativeDecoder:
    """Speculative decoding over the paged servers: a small DRAFT model
    proposes ``k-1`` tokens autoregressively, the TARGET model scores all
    ``k`` positions in ONE chunked decode call
    (:meth:`BatchServer.advance_chunk`).

    ``temperature == 0`` (default): greedy — the longest draft prefix
    agreeing with the target's argmax is accepted (+1 corrected token); the
    emitted stream is IDENTICAL to target-only greedy decoding.

    ``temperature > 0``: rejection sampling (Leviathan et al.) — draft
    token d_j is accepted with probability min(1, p_j(d_j)/q_j(d_j)); on
    rejection a replacement is drawn from normalize(max(0, p_j - q_j)); if
    all proposals are accepted a bonus token is drawn from p_k. The emitted
    tokens are distributed EXACTLY as target-only sampling at that
    temperature. The draws come from a host-side numpy generator seeded by
    ``seed`` over f64 copies of the logits, as in the JAX class.

    Rejected tokens' K/V are dropped with :meth:`BatchServer.rewind` (their
    page slots are simply reused). ``server_cls`` builds both servers
    (``functools.partial(ModernBatchServer, quantize_bits=4)`` for int4
    servers). Both servers are fed the same prompts via :meth:`add`.
    """

    def __init__(self, target_model, draft_model, *, k: int = 4,
                 page_size: int = 128, total_pages: int = 512,
                 temperature: float = 0.0, seed: int = 0,
                 server_cls=None):
        if server_cls is None:
            server_cls = (BatchServer if hasattr(target_model, "encoder")
                          else ModernBatchServer)
        self.k = k
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.target = server_cls(target_model, page_size=page_size,
                                 total_pages=total_pages)
        self.draft = server_cls(draft_model, page_size=page_size,
                                total_pages=total_pages)

    def add(self, seq_id, prompt_tokens) -> None:
        self.target.add(seq_id, prompt_tokens)
        self.draft.add(seq_id, prompt_tokens)

    def remove(self, seq_id) -> None:
        self.target.remove(seq_id)
        self.draft.remove(seq_id)

    @property
    def active(self):
        return self.target.active

    @staticmethod
    def _softmax(logits, temperature):
        z = logits / temperature
        z = z - z.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)

    def step(self) -> Dict:
        """One speculative round; returns {seq_id: [emitted tokens]} (1 to
        ``k`` tokens per sequence)."""
        seq_ids = self.active
        if not seq_ids:
            return {}
        k = self.k
        b = len(seq_ids)
        sampling = self.temperature > 0
        dev = self.draft.device
        # 1. draft proposes: inputs p0 (pending token), d1, ..., d_{k-2};
        #    outputs d1..d_{k-1}
        proposals = np.zeros((b, k), np.int64)
        proposals[:, 0] = [self.target.last_token[s] for s in seq_ids]
        q_dists = []  # [k-1] entries of [B, V] draft distributions
        for j in range(1, k):
            logits = self.draft._advance(
                seq_ids, torch.as_tensor(proposals[:, j - 1], device=dev))
            if sampling:
                q = self._softmax(logits.cpu().numpy().astype(np.float64),
                                  self.temperature)
                q_dists.append(q)
                for i in range(b):
                    proposals[i, j] = self.rng.choice(q.shape[1], p=q[i])
            else:
                proposals[:, j] = logits.argmax(-1).cpu().numpy()
        # 2. target verifies all k positions at once
        tlogits = self.target.advance_chunk(seq_ids, proposals)
        if sampling:
            p_dists = self._softmax(tlogits.cpu().numpy().astype(np.float64),
                                    self.temperature)  # [B, k, V]
        t_next = tlogits.argmax(-1).cpu().numpy()  # [B, k]: t1..tk
        out = {}
        for i, s in enumerate(seq_ids):
            emitted = []
            if sampling:
                # rejection sampling: accept d_j w.p. min(1, p/q); replace
                # from the normalized positive residual on rejection
                for j in range(1, k):
                    d = int(proposals[i, j])
                    p_j = p_dists[i, j - 1]
                    q_j = q_dists[j - 1][i]
                    if self.rng.uniform() < min(
                            1.0, p_j[d] / max(q_j[d], 1e-30)):
                        emitted.append(d)
                    else:
                        resid = np.maximum(p_j - q_j, 0.0)
                        tot = resid.sum()
                        dist = resid / tot if tot > 0 else p_j
                        emitted.append(int(self.rng.choice(len(dist),
                                                           p=dist)))
                        break
                else:  # all accepted: bonus token from the target
                    pk = p_dists[i, k - 1]
                    emitted.append(int(self.rng.choice(len(pk), p=pk)))
            else:
                # greedy: accept while the draft matches the target's argmax
                for j in range(1, k):
                    if proposals[i, j] == t_next[i, j - 1]:
                        emitted.append(int(proposals[i, j]))
                    else:
                        break
                # +1: the target's token at the first mismatch (or position k)
                emitted.append(int(t_next[i, len(emitted)]))
            n_emit = len(emitted)
            # 3. roll back both servers to the accepted history: the target
            #    wrote k rows, the draft k-1; each needs old_len + n_emit
            #    rows (the newest token stays pending)
            self.target.rewind(s, k - n_emit)
            if n_emit == k:
                # the draft never processed d_{k-1} (== t_{k-1}); feed it so
                # that the draft's history matches before the next round
                self.draft._advance(
                    [s], torch.as_tensor([int(proposals[i, k - 1])],
                                         device=dev))
            else:
                self.draft.rewind(s, (k - 1) - n_emit)
            self.target.last_token[s] = emitted[-1]
            self.draft.last_token[s] = emitted[-1]
            out[s] = emitted
        return out


def draft_view(model, num_blocks: int):
    """A truncated VIEW of a :class:`~lamp_tpu_torch.nn.ModernLM`: its first
    ``num_blocks`` transformer blocks plus the shared final norm, LM head,
    embedding and RoPE tables. Every tensor is the full model's own (the
    same ``Parameter`` and buffer objects): no device memory is copied."""
    if not 0 < num_blocks <= len(model.blocks):
        raise ValueError(
            f"num_blocks must be in [1, {len(model.blocks)}], got "
            f"{num_blocks}")
    return ModernLM(model.token_embedding, list(model.blocks[:num_blocks]),
                    model.final_norm, model.lm_head, model.rope_cos,
                    model.rope_sin, context_length=model.context_length)


class LoRADraftSpeculativeDecoder(SpeculativeDecoder):
    """Speculative decoding whose DRAFT shares the target's weights: the
    draft is the target's first ``L`` blocks with a LoRA adapter on the
    block projections, so the only extra device memory is the adapter's
    factors and a KV pool of ``L`` layers.

    ``lora_draft`` is a :func:`~lamp_tpu_torch.nn.lora_inject`-ed
    :func:`draft_view` of the target (the adapter on the block
    q/k/v/o/w1/w3/w2 projections only, as
    :meth:`ModernBatchServer.register_adapter` needs); its block count
    sets the draft's depth. The draft server's decode weights are the
    target server's own tensors (its extras tuples sliced, the packed int4
    weights included), and every request's draft copy runs under the
    adapter ``"draft"``. Acceptance and rollback are
    :class:`SpeculativeDecoder`'s, so the emitted stream keeps the
    target's distribution whatever the draft. ``draft_total_pages`` sizes
    the draft's pool (default: ``total_pages``, as the target's);
    ``server_kwargs`` go to both servers (``quantize_bits=4``,
    ``kv_dtype``, ...)."""

    def __init__(self, model, lora_draft, *, k: int = 4,
                 page_size: int = 128, total_pages: int = 512,
                 draft_total_pages: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0, **server_kwargs):
        if hasattr(model, "encoder"):
            raise NotImplementedError(
                "LoRA-draft speculation serves the ModernLM family")
        n_draft = len(lora_draft.blocks)
        if n_draft > len(model.blocks):
            raise ValueError(f"draft has {n_draft} blocks but the target "
                             f"only {len(model.blocks)}")
        self.k = k
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.target = ModernBatchServer(model, page_size=page_size,
                                        total_pages=total_pages,
                                        **server_kwargs)
        te = self.target._extras

        class _SharedExtrasServer(ModernBatchServer):
            """A draft server whose decode weights are slices of the target
            server's extras tuples: the same tensors."""

            def _precompute_extras(self, m):
                wqkv, wo, w1, w3, w2, lmh = te
                n = len(m.blocks)
                return (wqkv[:n], wo[:n], w1[:n], w3[:n], w2[:n], lmh)

        self.draft = _SharedExtrasServer(
            draft_view(model, n_draft), page_size=page_size,
            total_pages=(total_pages if draft_total_pages is None
                         else draft_total_pages),
            **server_kwargs)
        self.draft.register_adapter("draft", lora_draft)

    def add(self, seq_id, prompt_tokens) -> None:
        self.target.add(seq_id, prompt_tokens)
        self.draft.add(seq_id, prompt_tokens, adapter="draft")
