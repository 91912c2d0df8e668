"""Model adapters: the seam between the scheduler (engine.py) and a model
family's step functions.

The adapter owns everything model-specific (config, weight init, rope
cache, the KV-cache layout, the step programs); the engine stays a
page-table and scheduling loop over opaque ``caches``.

The Llama adapter serves the padded ``prefill``, the packed multi-prompt
``prefill_packed``, the ``prefill_extend`` of a cached prefix or a prompt
chunk, and the ``decode`` step; the engine reaches ``mixed_step`` through
``_m``. The Mixtral adapter serves the same four programs of its own model
over the same (k, v) pools, and the DeepSeek adapter over one latent pool
(with NSA sparse decode, the latent pool and the two indexer pools);
neither model has a ``mixed_step``, so the engine advances their chunked
prompts by extend. ``supports_spec`` is False (speculative decoding is a
later slice), and the PD page transfer (``extract_pages`` /
``inject_pages``) is not ported yet.

The engine captures each adapter's ``decode`` into a CUDA graph
(``serving/decode_graph.py``), so a decode reads nothing back to the host,
makes no tensor whose shape depends on values on the device, updates the
pools it is given in place (and returns them), and launches every kernel
on the current stream. Every decode here does so as written: the MoE
alignment counts by a scatter-add, the NSA top-k is a fixed-width sort, the
latent store redirects its dropped rows on the device.
"""

from __future__ import annotations

from ..models import deepseek, llama, mixtral
from ..utils import resolve_device


class LlamaAdapter:
    """Llama dense family (models/llama.py) over (k_pool, v_pool) caches."""

    name = "llama"
    supports_spec = False
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
                       prefix_max: int):
        k, v = caches
        logits, k, v = self._m.prefill_extend(params, self.cfg, k, v, tokens, positions, q_lens, kv_lens,
                                              page_tables, slot_loc, self.rope_cache, prefix_max=prefix_max)
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
    supports_spec = False
    supports_extend = True

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self._m = mixtral


class DeepseekAdapter:
    """DeepSeek MLA family (models/deepseek.py) over the cache
    ``(latent_pool,)``, [L, P, page, 576], or with ``use_nsa`` (NSA sparse
    decode) ``(latent_pool, idx_k, idx_s)``, the indexer's fp8 keys and
    scales, every program routed to its NSA form. The page size is the
    caller's: the JAX adapter's ``recommended_page_size = 1024`` is a TPU
    finding (adapters.py:258-265) this port does not rely on. KV compression
    (``use_compress``) is not ported and raises."""

    name = "deepseek"
    supports_spec = False
    supports_extend = True

    def __init__(self, cfg, device="cuda", *, use_nsa: bool = False, use_compress: bool = False):
        if use_compress:
            raise NotImplementedError("DeepseekAdapter: KV compression is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._m = deepseek
        self.use_nsa = use_nsa
        self.rope_cache = deepseek.build_rope_cache(cfg, self.device)
        self.idx_rope_cache = deepseek.build_idx_rope_cache(cfg, self.device) if use_nsa else None

    def init_weights(self, generator):
        return self._m.init_weights(self.cfg, generator, self.device)

    def make_caches(self, num_pages: int, page_size: int):
        kv = self._m.make_cache(self.cfg, num_pages, page_size, device=self.device)
        if not self.use_nsa:
            return (kv,)
        return (kv, *self._m.make_indexer_cache(self.cfg, num_pages, page_size, device=self.device))

    def _indexer(self, caches):
        """The model's ``indexer`` argument: None, or (idx_k, idx_s, rope)."""
        return (caches[1], caches[2], self.idx_rope_cache) if self.use_nsa else None

    def prefill(self, params, caches, tokens, positions, q_lens, slot_loc):
        logits, kv = self._m.prefill(params, self.cfg, caches[0], tokens, positions, q_lens, slot_loc,
                                     self.rope_cache, indexer=self._indexer(caches))
        return logits, (kv, *caches[1:])

    def prefill_extend(self, params, caches, tokens, positions, q_lens, kv_lens, page_tables, slot_loc, *,
                       prefix_max: int):
        logits, kv = self._m.prefill_extend(params, self.cfg, caches[0], tokens, positions, q_lens, kv_lens,
                                            page_tables, slot_loc, self.rope_cache, prefix_max=prefix_max,
                                            indexer=self._indexer(caches))
        return logits, (kv, *caches[1:])

    def decode(self, params, caches, tokens, positions, page_tables, lengths, slot_loc):
        logits, kv = self._m.decode_step(params, self.cfg, caches[0], tokens, positions, page_tables, lengths,
                                         slot_loc, self.rope_cache, indexer=self._indexer(caches))
        return logits, (kv, *caches[1:])

    def prefill_packed(self, params, caches, tokens, positions, blk_seq, blk_q0, seq_meta, last_idx, slot_loc, *,
                       max_kvb: int):
        """Several fresh prompts block-aligned packed into one launch (the
        indexer keys stored too under NSA)."""
        idx = caches[1:] if self.use_nsa else (None, None)
        out = self._m.prefill_packed(params, self.cfg, caches[0], *idx, tokens, positions, blk_seq, blk_q0,
                                     seq_meta, last_idx, slot_loc, self.rope_cache, max_kvb=max_kvb,
                                     with_indexer=self.use_nsa, idx_rope_cache=self.idx_rope_cache)
        return out[0], (out[1], *caches[1:])


def adapter_for(cfg, device="cuda"):
    """The adapter for a config's type, the most specific first
    (``MixtralConfig`` is a ``LlamaConfig``); a DeepSeek config asks for the
    decode mode it names (NSA, or compression, which raises)."""
    if isinstance(cfg, deepseek.DeepseekConfig):
        return DeepseekAdapter(cfg, device, use_nsa=bool(cfg.nsa), use_compress=bool(cfg.compress))
    if isinstance(cfg, mixtral.MixtralConfig):
        return MixtralAdapter(cfg, device)
    if isinstance(cfg, llama.LlamaConfig):
        return LlamaAdapter(cfg, device)
    raise TypeError(f"no serving adapter for config type {type(cfg).__name__}")
