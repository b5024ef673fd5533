"""Batch LM serving over the paged KV cache.

Counterpart of :mod:`lamp_tpu.models.serving` for the llama-style
:class:`~lamp_tpu_torch.nn.ModernLM`: a continuous-batching decode engine in
which concurrent sequences of different lengths share one physical page
pool, and requests join and leave the batch between steps.

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

Not ported yet (each raises ``NotImplementedError`` when asked for): the
GPT ``BatchServer`` model path, penalties, constrained decoding, LoRA
adapters, ``n``/``best_of`` fan-out, the prefix cache, tensor parallelism,
chunked decode.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import mha_reference
from ..ops.paged_attention import paged_attention
from ..ops.quantization import (int4_group_size, int4_matmul, int8_matmul,
                                quantize_int4, quantize_int8)
from ..nn.modern import apply_rope
from .sampling import NUCLEUS_CAND, SamplingParams, sample_tokens

__all__ = ["BatchServer", "ModernBatchServer", "ServingEngine",
           "SamplingParams"]


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
    """Paged-KV batch decode: page pool, request lifecycle, sampling and
    the multi-step decode loop, independent of the model family. The model
    hooks (``_introspect``, ``_precompute_extras``, ``_decode_step``,
    ``_prefill_seq``) are :class:`ModernBatchServer`'s; the GPT
    (``LanguageModelModule``) server is not ported yet."""

    def _introspect(self, model):
        raise NotImplementedError(
            "BatchServer for LanguageModelModule (GPT); use ModernBatchServer")

    def __init__(self, model, *, page_size: int = 128,
                 total_pages: int = 512, temperature: float = 0.0,
                 seed: int = 0, quantize_bits: Optional[int] = None,
                 enable_prefix_cache: bool = False, kv_dtype=None):
        if quantize_bits not in (None, 4, 8):
            raise ValueError("quantize_bits must be None, 4 or 8")
        self.quantize_bits = quantize_bits
        if enable_prefix_cache:
            raise NotImplementedError("enable_prefix_cache")
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
        self.vocab = model.token_embedding.weight.shape[0]
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps_decoded = 0  # decode steps run (each: one kernel per layer)
        self._extras = self._precompute_extras(model)

    # -- request lifecycle --------------------------------------------------
    def add(self, seq_id, prompt_tokens,
            params: Optional[SamplingParams] = None,
            adapter: Optional[str] = None,
            window: Optional[int] = None,
            constraint: Optional[str] = None) -> None:
        """Admit a request: dense prefill of all but the last prompt token,
        whose K/V rows are written into freshly allocated pages. ``params``
        sets per-request sampling controls (default: the server-level
        ``temperature``). ``window`` caps THIS request's attention to its
        last ``window`` tokens (the tighter of it and a layer's window
        wins); when every layer ends up windowed, pages that fall below the
        band are released back to the pool mid-generation."""
        if seq_id in self.seq_pages:
            raise ValueError(f"duplicate request {seq_id}")
        if adapter is not None:
            raise NotImplementedError("LoRA adapters")
        if constraint is not None:
            raise NotImplementedError("constrained decoding")
        if window is not None:
            window = int(window)
            if window <= 0:
                raise ValueError("window must be a positive int")
        sp = params or SamplingParams(temperature=self.temperature)
        if sp.has_penalties:
            raise NotImplementedError("sampling penalties")
        self.seq_window[seq_id] = window
        self.seq_released[seq_id] = 0
        self.seq_params[seq_id] = sp
        if sp.logprobs:
            self.seq_logprobs[seq_id] = []
        self.seq_pages[seq_id] = []
        self.seq_len[seq_id] = 0
        prompt = np.asarray(prompt_tokens).reshape(-1)
        n_prefill = len(prompt) - 1
        if n_prefill > 0:
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
        self.last_token[seq_id] = int(prompt[-1])
        self._release_pages(seq_id)

    def remove(self, seq_id) -> None:
        pages = self.seq_pages.pop(seq_id)
        self.free_pages.extend(pg for pg in pages if pg >= 0)
        self.seq_len.pop(seq_id)
        self.last_token.pop(seq_id)
        self.seq_params.pop(seq_id, None)
        self.seq_window.pop(seq_id, None)
        self.seq_released.pop(seq_id, None)
        self.seq_logprobs.pop(seq_id, None)

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
                self.free_pages.append(pages[j])
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

    @property
    def active(self) -> List:
        return list(self.seq_pages)

    @property
    def available_pages(self) -> int:
        """Pages the allocator can hand out."""
        return len(self.free_pages)

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
            if not self.free_pages:
                raise RuntimeError("KV page pool exhausted")
            pages.append(self.free_pages.pop())
        return pages[pos // self.page_size], pos % self.page_size

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
            self._windows_arg(seq_ids))
        for s in seq_ids:
            self.seq_len[s] += 1
        return logits

    def _sampling_arrays(self, seq_ids):
        """(temperature [B] | None, top_k [B] | None, top_p [B] | None,
        min_p [B] | None, max_top_k, want_logprobs). A filter is None when
        no request uses it; temperature is None when the whole batch is
        greedy (a bare argmax, no random draws)."""
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
        want_lp = any(p.logprobs for p in ps)
        return temps, top_k, top_p, min_p, max_top_k, want_lp

    def _sample(self, logits, arrays):
        temps, top_k, top_p, min_p, mtk, want_lp = arrays
        out = sample_tokens(logits, self.generator, temps, top_k, top_p,
                            min_p=min_p, max_top_k=mtk,
                            return_logprobs=want_lp)
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
        nxt, lps = self._sample(logits, self._sampling_arrays(seq_ids))
        # ONE device->host copy for the whole batch
        out = self._record(seq_ids, nxt.cpu().numpy()[None],
                           None if lps is None else lps.cpu().numpy()[None])
        return {s: t[0] for s, t in out.items()}

    def step_many(self, n: int) -> Dict:
        """Decode ``n`` tokens for every active request; returns {seq_id:
        [tok, ...]}. All n slots are allocated up front (and pages released
        once), then n decode steps run back to back with sampling on the
        device, each step's tokens feeding the next; one device->host copy
        at the end. No request joins or leaves between the n steps."""
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
        arrays = self._sampling_arrays(seq_ids)
        toks, lps = [], []
        for i in range(n):
            logits = self._decode_step(tok, idx, lens0 + i, tp[:, i],
                                       ts[:, i], windows)
            tok, lp = self._sample(logits, arrays)
            toks.append(tok)
            lps.append(lp)
        toks_host = torch.stack(toks).cpu().numpy()  # [n, B]
        lps_host = (None if lps[0] is None
                    else torch.stack(lps).cpu().numpy())
        return self._record(seq_ids, toks_host, lps_host)


class ModernBatchServer(BatchServer):
    """Paged-KV batch decode for :class:`lamp_tpu_torch.nn.ModernLM` (RoPE +
    GQA + RMSNorm + SwiGLU). The pool holds ``num_kv_heads`` fused head rows;
    RoPE rotates q/k at each token's absolute position before the pages are
    written, so the cached keys are already position-encoded."""

    def __init__(self, model, *, mesh=None, **kwargs):
        if mesh is not None:
            raise NotImplementedError("mesh= (tensor-parallel serving)")
        super().__init__(model, **kwargs)

    def _introspect(self, model):
        block = model.blocks[0]
        self.layers = len(model.blocks)
        self.heads = block.num_heads
        self.kv_heads = block.num_kv_heads
        self.head_dim = block.w_q.weight.shape[1] // self.heads
        # per-layer sliding windows: the kernel walks only each layer's band
        self._windows = tuple(b.window for b in model.blocks)

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

    def _precompute_extras(self, model):
        """Decode-path weights: fused per-layer QKV, attention
        out-projection, the three SwiGLU matrices and the logits matrix,
        each through :meth:`_quantize_weight`. Unquantized, the logits
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
                     token_slots, req_windows=None):
        """Process a [B] batch of tokens sitting at positions ``lengths``:
        attend over history + self, write every layer's K/V into
        (token_pages, token_slots) of the pool, return logits [B, V] f32."""
        self.steps_decoded += 1
        model = self.model
        b = tokens.shape[0]
        wqkv, wo, w1, w3, w2, lmh = self._extras
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
        deferred_rows = []  # per-layer (k_rows, v_rows) written after loop
        for li, block in enumerate(model.blocks):
            y = mm(block.norm1(x), wqkv[li])
            q = rot(y[:, :nq].reshape(b, self.heads, hd))
            kk_f = rot(y[:, nq:nq + nkv].reshape(b, self.kv_heads, hd)
                       ).reshape(b, nkv)
            vv_f = y[:, nq + nkv:].contiguous()
            # the current token's K/V is INJECTED into the kernel
            # (append_kv), so the pool write is deferred out of the loop
            deferred_rows.append((kk_f, vv_f))
            o = paged_attention(
                q, self.kv_pages, None, page_idx, lengths,
                num_kv_heads=self.kv_heads,
                window=self._windows[li], windows=req_windows,
                append_kv=(kk_f, vv_f),
                page_offset=li * self.total_pages,
            )
            x = x + mm(o.reshape(b, nq), wo[li])
            h = block.norm2(x)
            x = x + mm(F.silu(mm(h, w1[li])) * mm(h, w3[li]), w2[li])
        _kv_write_stacked(self.kv_pages, self.total_pages, token_pages,
                          token_slots, deferred_rows)
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


class ServingEngine:
    """Continuous-batching scheduler over a :class:`ModernBatchServer`.

    Requests are submitted with per-request :class:`SamplingParams`
    (temperature / top-k / top-p / ``max_tokens`` / ``stop_tokens``) and
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
                 max_batch: int = 64):
        self.server = server
        self.decode_steps = decode_steps
        self.max_batch = max_batch
        self.pending = deque()       # (rid, prompt list, params, window)
        self.generated: Dict = {}    # rid -> [tokens so far]
        self.results: Dict = {}      # rid -> finished token list
        # chosen-token logprobs for requests with SamplingParams.logprobs,
        # aligned 1:1 with the emitted tokens (stop token excluded)
        self.result_logprobs: Dict = {}
        self._generated_lp: Dict = {}
        self._reserve: Dict = {}     # rid -> worst-case total pages
        self._max_new: Dict = {}     # rid -> decode budget
        self._next_id = 0
        self._retired = 0            # finished requests

    def submit(self, prompt_tokens, params: Optional[SamplingParams] = None,
               request_id=None, adapter: Optional[str] = None,
               window: Optional[int] = None,
               constraint: Optional[str] = None, n: int = 1,
               best_of: Optional[int] = None):
        """Queue a request; returns its id. Decoding starts once pages are
        available (see :meth:`step`). ``window`` caps the request's
        attention to its last ``window`` tokens."""
        if adapter is not None:
            raise NotImplementedError("LoRA adapters")
        if constraint is not None:
            raise NotImplementedError("constrained decoding")
        if n != 1 or best_of is not None:
            raise NotImplementedError("n / best_of fan-out")
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
        if params.has_penalties:
            raise NotImplementedError("sampling penalties")
        if window is not None and int(window) <= 0:
            raise ValueError("window must be a positive int")
        self.pending.append((rid, prompt, params, window))
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
            rid, prompt, params, window = self.pending[0]
            max_new = self._budget(len(prompt), params)
            need = self._pages_for(len(prompt), max_new, window)
            if s.available_pages < owed + need:
                break
            self.pending.popleft()
            s.add(rid, prompt, params, window=window)
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
                if len(g) >= self._max_new[rid]:
                    done = True
                    break
            if done:
                finished[rid] = g
        for rid in finished:
            self._retire(rid)
            self.results[rid] = self.generated.pop(rid)
            lp = self._generated_lp.pop(rid, None)
            if lp is not None:
                self.result_logprobs[rid] = lp
        return {rid: self.results[rid] for rid in finished}

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
        immediately and it never appears in :attr:`results`. Returns False
        when the id is unknown or already finished."""
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
