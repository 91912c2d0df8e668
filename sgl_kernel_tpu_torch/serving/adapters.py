"""Model adapters: the seam between the scheduler (engine.py) and a model
family's step functions.

The adapter owns everything model-specific (config, weight init, rope
cache, the KV-cache layout, the step programs); the engine stays a
page-table and scheduling loop over opaque ``caches``.

The Llama adapter serves the padded ``prefill``, the packed multi-prompt
``prefill_packed``, the ``prefill_extend`` of a cached prefix or a prompt
chunk, and the ``decode`` step; the engine reaches ``mixed_step`` through
``_m``. The Mixtral adapter serves the same four programs of its own model
over the same (k, v) pools, as does the gpt-oss adapter (sinks, a window on
even layers, MXFP4 experts), and the DeepSeek adapter over one latent pool
(with NSA sparse decode, the latent pool and the two indexer pools;
with KV compression, the latent pool, the score pool and the ring pool);
neither model has a ``mixed_step``, so the engine advances their chunked
prompts by extend. ``supports_spec`` says whether the engine may put a
draft in front of the family (``models/spec.py``): its ``prefill_extend``
takes ``num_logits`` for the chain verify, as JAX's Llama, Mixtral and
DeepSeek do. gpt-oss, DeepSeek with NSA decode and DeepSeek with KV
compression take no draft. The PD page and state transfer
(``extract_pages`` / ``inject_pages``, ``extract_state`` /
``inject_state``) is not ported yet.

An adapter with ``needs_state_slots`` (DeepSeek with KV compression, hybrid
GDN) keeps per-request state outside the pages: its ``make_caches`` takes
``max_slots`` and its programs take ``state_slots``, each row's slot in that
state, which the engine assigns. The hybrid GDN adapter serves ``prefill``,
``prefill_extend`` (a prompt's later chunks, continuing its recurrence)
and ``decode`` over the caches (k_pool, v_pool, conv_pool, ssm_pool), and
says ``supports_prefix_reuse = False``: it chunks its own prompts, but the
recurrent state behind another request's cached prefix does not exist, so
the engine runs it with the prefix cache off.

The engine captures each adapter's ``decode`` into a CUDA graph
(``serving/decode_graph.py``), so a decode reads nothing back to the host,
makes no tensor whose shape depends on values on the device, updates the
pools it is given in place (and returns them), and launches every kernel
on the current stream. Every decode here does so as written: the MoE
alignment counts by a scatter-add, the NSA top-k is a fixed-width sort, the
latent store and the compression ring's writes redirect their dropped rows
on the device (the compressed decode pools on every step and drops the
writes of rows with no event, where JAX branches), and the hybrid GDN decode
gathers its slots' state rows by ``index_select`` and writes them back by
``index_copy_``.
"""

from __future__ import annotations

import torch

from ..models import deepseek, gptoss, hybrid_gdn, llama, mixtral
from ..utils import resolve_device


class LlamaAdapter:
    """Llama dense family (models/llama.py) over (k_pool, v_pool) caches."""

    name = "llama"
    supports_spec = True  # a Llama-family draft in front (models/spec.py); trees through prefill_tree
    supports_extend = True  # prefill_extend: prefix reuse + chunked prefill

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._m = llama
        self.rope_cache = llama.build_rope_cache(cfg, self.device)

    def init_weights(self, generator):
        return self._m.init_weights(self.cfg, generator, self.device)

    def make_caches(self, num_pages: int, page_size: int):
        return tuple(self._m.make_caches(self.cfg, num_pages, page_size, device=self.device))

    def prefill(self, params, caches, tokens, positions, q_lens, slot_loc):
        k, v = caches
        logits, k, v = self._m.prefill(params, self.cfg, k, v, tokens, positions, q_lens,
                                       slot_loc, self.rope_cache)
        return logits, (k, v)

    def prefill_extend(self, params, caches, tokens, positions, q_lens, kv_lens, page_tables, slot_loc, *,
                       prefix_max: int, num_logits: int = 1):
        k, v = caches
        logits, k, v = self._m.prefill_extend(params, self.cfg, k, v, tokens, positions, q_lens, kv_lens,
                                              page_tables, slot_loc, self.rope_cache, prefix_max=prefix_max,
                                              num_logits=num_logits)
        return logits, (k, v)

    def prefill_packed(self, params, caches, tokens, positions, blk_seq, blk_q0, seq_meta, last_idx, slot_loc,
                       *, max_kvb: int):
        """Several fresh prompts block-aligned packed into one launch
        (ops/attention/flash_packed.py)."""
        k, v = caches
        logits, k, v = self._m.prefill_packed(params, self.cfg, k, v, tokens, positions, blk_seq, blk_q0,
                                              seq_meta, last_idx, slot_loc, self.rope_cache, max_kvb=max_kvb)
        return logits, (k, v)

    def decode(self, params, caches, tokens, positions, page_tables, lengths, slot_loc):
        k, v = caches
        logits, k, v = self._m.decode_step(params, self.cfg, k, v, tokens, positions,
                                           page_tables, lengths, slot_loc, self.rope_cache)
        return logits, (k, v)


class MixtralAdapter(LlamaAdapter):
    """Mixtral routed-MoE Llama (models/mixtral.py): the Llama adapter's
    programs and (k, v) pools over the Mixtral model's functions."""

    name = "mixtral"
    supports_spec = True  # chain speculation (no tree program)
    supports_extend = True

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self._m = mixtral


class GptOssAdapter(MixtralAdapter):
    """gpt-oss (models/gptoss.py): attention sinks, a sliding window on
    even layers and the clamped-swiglu MoE over the Mixtral adapter's
    programs and (k, v) pools (adapters.py:142-155 of the JAX package).
    Extend runs both flash passes sink-free and applies the sinks once after
    the merge. Its decode is capturable as the others': each layer's window
    is a Python int, the sinks a slice of the stacked tree. It takes no
    draft: JAX's ``GptOssAdapter`` inherits ``supports_spec`` but its extend
    has no ``num_logits``, so the JAX engine fails at its first round
    (ROADMAP queue 3)."""

    name = "gptoss"
    supports_spec = False

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self._m = gptoss


class DeepseekAdapter:
    """DeepSeek MLA family (models/deepseek.py) over the cache
    ``(latent_pool,)``, [L, P, page, 576], or with ``use_nsa`` (NSA sparse
    decode) ``(latent_pool, idx_k, idx_s)``, the indexer's fp8 keys and
    scales, every program routed to its NSA form. With ``use_compress`` (KV
    compression, ``cfg.compress``) the cache is ``(latent_pool, score_pool,
    ring_pool)`` and the programs are the compressed family's: a request's
    ring is state that lives in its state slot (``needs_state_slots``), and
    there is no extend program (a ring is not shared by a prefix), so the
    engine serves it with the prefix cache off and no chunking. The page
    size is the caller's: the JAX adapter's ``recommended_page_size = 1024``
    is a TPU finding (adapters.py:258-265) this port does not rely on."""

    name = "deepseek"
    supports_spec = True  # chain speculation on the dense MLA decode; not with NSA or compression
    supports_extend = True
    needs_state_slots = False

    def __init__(self, cfg, device="cuda", *, use_nsa: bool = False, use_compress: bool = False):
        if use_compress:
            if use_nsa:
                raise ValueError("DeepseekAdapter: compression and NSA decode are exclusive modes")
            if cfg.compress not in ("c4", "c128"):
                raise ValueError(f"DeepseekAdapter(use_compress=True) needs compress 'c4' or 'c128', "
                                 f"not {cfg.compress!r}")
            self.needs_state_slots = True
            self.supports_extend = False
        if use_nsa or use_compress:
            self.supports_spec = False
        self.cfg = cfg
        self.device = resolve_device(device)
        self._m = deepseek
        self.use_nsa = use_nsa
        self.use_compress = use_compress
        self.rope_cache = deepseek.build_rope_cache(cfg, self.device)
        self.idx_rope_cache = deepseek.build_idx_rope_cache(cfg, self.device) if use_nsa else None

    def init_weights(self, generator):
        return self._m.init_weights(self.cfg, generator, self.device)

    def make_caches(self, num_pages: int, page_size: int, max_slots: int = 16):
        if self.use_compress:
            return self._m.make_compress_caches(self.cfg, num_pages, page_size, max_slots, device=self.device)
        kv = self._m.make_cache(self.cfg, num_pages, page_size, device=self.device)
        if not self.use_nsa:
            return (kv,)
        return (kv, *self._m.make_indexer_cache(self.cfg, num_pages, page_size, device=self.device))

    def _indexer(self, caches):
        """The model's ``indexer`` argument: None, or (idx_k, idx_s, rope)."""
        return (caches[1], caches[2], self.idx_rope_cache) if self.use_nsa else None

    def prefill(self, params, caches, tokens, positions, q_lens, slot_loc, state_slots=None):
        if self.use_compress:
            logits, *caches = self._m.prefill_c(params, self.cfg, *caches, tokens, positions, q_lens, slot_loc,
                                                state_slots, self.rope_cache)
            return logits, tuple(caches)
        logits, kv = self._m.prefill(params, self.cfg, caches[0], tokens, positions, q_lens, slot_loc,
                                     self.rope_cache, indexer=self._indexer(caches))
        return logits, (kv, *caches[1:])

    def prefill_extend(self, params, caches, tokens, positions, q_lens, kv_lens, page_tables, slot_loc, *,
                       prefix_max: int, num_logits: int = 1):
        if self.use_compress:
            raise ValueError("DeepseekAdapter: the compressed family has no extend program")
        logits, kv = self._m.prefill_extend(params, self.cfg, caches[0], tokens, positions, q_lens, kv_lens,
                                            page_tables, slot_loc, self.rope_cache, prefix_max=prefix_max,
                                            num_logits=num_logits, indexer=self._indexer(caches))
        return logits, (kv, *caches[1:])

    def decode(self, params, caches, tokens, positions, page_tables, lengths, slot_loc, state_slots=None):
        if self.use_compress:
            logits, *caches = self._m.decode_step_c(params, self.cfg, *caches, tokens, positions, page_tables,
                                                    lengths, slot_loc, state_slots, self.rope_cache)
            return logits, tuple(caches)
        logits, kv = self._m.decode_step(params, self.cfg, caches[0], tokens, positions, page_tables, lengths,
                                         slot_loc, self.rope_cache, indexer=self._indexer(caches))
        return logits, (kv, *caches[1:])

    def prefill_packed(self, params, caches, tokens, positions, blk_seq, blk_q0, seq_meta, last_idx, slot_loc, *,
                       max_kvb: int, state_slots=None):
        """Several fresh prompts block-aligned packed into one launch (the
        indexer keys stored too under NSA; the score rows stored and the rings
        built under compression)."""
        if self.use_compress:
            logits, *caches = self._m.prefill_packed_c(params, self.cfg, *caches, tokens, positions, blk_seq,
                                                       blk_q0, seq_meta, last_idx, slot_loc, state_slots,
                                                       self.rope_cache, max_kvb=max_kvb)
            return logits, tuple(caches)
        idx = caches[1:] if self.use_nsa else (None, None)
        out = self._m.prefill_packed(params, self.cfg, caches[0], *idx, tokens, positions, blk_seq, blk_q0,
                                     seq_meta, last_idx, slot_loc, self.rope_cache, max_kvb=max_kvb,
                                     with_indexer=self.use_nsa, idx_rope_cache=self.idx_rope_cache)
        return out[0], (out[1], *caches[1:])


class HybridGdnAdapter(LlamaAdapter):
    """Hybrid GDN, Qwen3-Next style (models/hybrid_gdn.py; JAX adapters.py:158-226):
    GDN layers alternating with paged GQA layers over the caches (k_pool,
    v_pool, conv_pool, ssm_pool). The GDN layers' conv window and SSM state
    live in slot-major pools [Lg, max_slots, ...]; every program gathers its
    rows' slots, runs the model on them and writes them back in place.
    ``prefill`` starts each request from a zero state (a recycled slot holds
    the previous request's), ``prefill_extend`` continues a request's own
    chunks from its slot. No prefix reuse, no packed prefill, no draft. The
    PD transfers (``extract_pages`` / ``inject_pages`` and the state's) wait
    for ``serving/pd.py``."""

    name = "hybrid_gdn"
    supports_spec = False
    supports_extend = True  # chunked prompts: the conv / SSM state carries across chunks
    supports_prefix_reuse = False  # recurrent state is not prefix-shareable
    needs_state_slots = True
    prefill_packed = None

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._m = hybrid_gdn
        self.rope_cache = hybrid_gdn.build_rope_cache(cfg, self.device)

    def make_caches(self, num_pages: int, page_size: int, max_slots: int = 16):
        k, v = self._m.make_caches(self.cfg, num_pages, page_size, device=self.device)
        conv, ssm = self._m.make_states(self.cfg, max_slots, device=self.device)
        return (k, v, conv, ssm)

    @staticmethod
    def recurrent_state(caches):
        """The pools a decode advances in place, not just rewrites: conv and
        SSM (serving/decode_graph.py undoes a capture's warm-up on them)."""
        return caches[2], caches[3]

    @staticmethod
    def _rows(caches, state_slots):
        """The slots as a long index on the pools' device, and the conv and
        SSM rows at them."""
        conv, ssm = caches[2], caches[3]
        rows = state_slots.to(device=conv.device, dtype=torch.long)
        return rows, conv.index_select(1, rows), ssm.index_select(1, rows)

    @staticmethod
    def _put(caches, rows, cs, ss):
        caches[2].index_copy_(1, rows, cs)
        caches[3].index_copy_(1, rows, ss)
        return tuple(caches)

    def prefill(self, params, caches, tokens, positions, q_lens, slot_loc, state_slots=None):
        k, v, conv, ssm = caches
        rows = state_slots.to(device=conv.device, dtype=torch.long)
        zc = conv.new_zeros((conv.shape[0], rows.shape[0], *conv.shape[2:]))
        zs = ssm.new_zeros((ssm.shape[0], rows.shape[0], *ssm.shape[2:]))
        logits, k, v, cs, ss = self._m.prefill(params, self.cfg, k, v, zc, zs, tokens, positions, q_lens,
                                               slot_loc, self.rope_cache)
        return logits, self._put(caches, rows, cs, ss)

    def prefill_extend(self, params, caches, tokens, positions, q_lens, kv_lens, page_tables, slot_loc, *,
                       prefix_max: int, state_slots=None):
        rows, cs, ss = self._rows(caches, state_slots)
        logits, *_ = self._m.prefill_extend(params, self.cfg, caches[0], caches[1], cs, ss, tokens, positions,
                                            q_lens, kv_lens, page_tables, slot_loc, self.rope_cache,
                                            prefix_max=prefix_max)
        return logits, self._put(caches, rows, cs, ss)

    def decode(self, params, caches, tokens, positions, page_tables, lengths, slot_loc, state_slots=None):
        rows, cs, ss = self._rows(caches, state_slots)
        logits, *_ = self._m.decode_step(params, self.cfg, caches[0], caches[1], cs, ss, tokens, positions,
                                         page_tables, lengths, slot_loc, self.rope_cache)
        return logits, self._put(caches, rows, cs, ss)


def adapter_for(cfg, device="cuda"):
    """The adapter for a config's type, the most specific first
    (``GptOssConfig`` is a ``MixtralConfig``; ``MixtralConfig`` and
    ``HybridGdnConfig`` are ``LlamaConfig``s); a DeepSeek config asks for
    the decode mode it names (NSA or compression; both together raise)."""
    if isinstance(cfg, deepseek.DeepseekConfig):
        return DeepseekAdapter(cfg, device, use_nsa=bool(cfg.nsa), use_compress=bool(cfg.compress))
    if isinstance(cfg, gptoss.GptOssConfig):
        return GptOssAdapter(cfg, device)
    if isinstance(cfg, hybrid_gdn.HybridGdnConfig):
        return HybridGdnAdapter(cfg, device)
    if isinstance(cfg, mixtral.MixtralConfig):
        return MixtralAdapter(cfg, device)
    if isinstance(cfg, llama.LlamaConfig):
        return LlamaAdapter(cfg, device)
    raise TypeError(f"no serving adapter for config type {type(cfg).__name__}")
