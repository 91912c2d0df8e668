"""Continuous-batching serving engine.

A paged-KV page allocator, a prefill/decode scheduler, and a step loop that
feeds the model adapter's programs. Each scheduler step:

- admits waiting requests while the batch has room. Each prompt is matched
  against the radix prefix cache (``serving/native.py``) and reuses its
  longest cached page-aligned prefix. Fresh prompts go into one
  block-aligned packed launch (``prefill_packed``); a prompt with a cached
  prefix goes through ``prefill_extend``; with ``prefill_chunk`` a longer
  prompt is ingested one chunk per step;
- fuses the first in-flight chunk with the decode batch into one
  ``mixed_step`` where it can (``enable_mixed``), else advances each chunked
  prefill by one chunk and runs one decode step over the running batch
  padded to ``max_batch``;
- retires finished requests: their full pages go to the prefix cache, the
  rest to the free list.

A decode step runs the adapter's ``decode`` over inputs at fixed addresses
(``serving/decode_graph.py``): on the card as a CUDA graph captured at the
first decode step and replayed after, the counterpart of JAX's jitted
``decode_step``; on the CPU eagerly. With ``decode_burst > 1`` a batch whose
requests are all greedy runs up to ``decode_burst`` steps in one graph, the
argmax fed back on the device (JAX's ``_make_burst_fn``); tokens past a stop
token are discarded on the host, and mixed steps are off.

Speculative decoding, grammars and a device mesh are later slices: the
arguments that ask for them raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.sampling import sample_tokens
from ..utils import cdiv, resolve_device
from ..utils.metrics import Metrics, logger
from .adapters import adapter_for
from .decode_graph import DecodeGraph, DecodeInputs


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    stop_tokens: tuple = ()
    output: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefix_len: int = 0          # tokens reused from the radix cache
    shared_pages: int = 0        # leading cache-owned pages in ``pages``
    lock_id: int = 0             # radix-cache pin handle (0 = none)
    prefill_pos: int = 0         # chunked-prefill progress (tokens stored)

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + len(self.output)


def packed_layout(lens: List[int], n_rows: int, block: int = 256):
    """The packed-prefill metadata of fresh prompts of ``lens``, as
    ``Engine._prefill_packed_batch`` builds it: each prompt starts at a
    block multiple; the block count is padded to a power of two, the
    padding blocks pointing at the empty pseudo-sequence row ``len(lens)``
    (q_len 0, kv_blks 1) of ``n_rows`` seq_meta rows. Returns (blk_seq,
    blk_q0, seq_meta, tok0, tp, max_kvb): int32 arrays, each prompt's first
    packed token, the packed token count and the power-of-two kv block cap."""
    nqb = [max(cdiv(n, block), 1) for n in lens]
    nb = 1 << (sum(nqb) - 1).bit_length()
    blk_seq = np.full(nb, len(lens), np.int32)
    blk_q0 = np.zeros(nb, np.int32)
    seq_meta = np.zeros((n_rows, 6), np.int32)
    seq_meta[:, 5] = 1  # kv_blks >= 1, as the JAX metadata has it
    tok0, b0 = [], 0
    for i, n in enumerate(lens):
        blk_seq[b0: b0 + nqb[i]] = i
        blk_q0[b0: b0 + nqb[i]] = np.arange(nqb[i]) * block
        seq_meta[i] = (n, n, 0, 0, b0, nqb[i])
        tok0.append(b0 * block)
        b0 += nqb[i]
    return blk_seq, blk_q0, seq_meta, tok0, nb * block, 1 << (max(nqb) - 1).bit_length()


class PageAllocator:
    """Free-list page allocator over the paged KV pool (page 0 reserved as
    the pad page: padding rows of a page table point at it)."""

    def __init__(self, num_pages: int):
        self.free = list(range(num_pages - 1, 0, -1))

    def alloc(self, n: int) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: List[int]):
        self.free.extend(pages)


class Engine:
    """Continuous batching on one device. ``device="cuda"`` (the default)
    runs the kernels on the card and raises without one; ``device="cpu"``
    runs the plain PyTorch versions.

    ``enable_prefix_cache`` (the default) needs the native serving library,
    which is compiled on first use: unlike the JAX engine, which then
    serves without the cache, this engine raises if the library cannot be
    built. An adapter without ``prefill_extend`` (``supports_extend =
    False``) turns the cache off and cannot chunk prompts; one without
    ``prefill_packed`` prefills each fresh prompt on its own.

    On the card every decode step is a CUDA graph replay (one graph per
    burst length, captured at its first use, released with the engine);
    ``_eager_decode = True`` runs the steps eagerly instead, for an A/B
    against the graph."""

    _PACK_BLOCK = 256  # flash_packed block / sequence alignment

    def __init__(
        self,
        cfg,
        params=None,
        *,
        max_batch: int = 8,
        num_pages: int = 512,
        page_size: int = 64,
        max_pages_per_seq: Optional[int] = None,
        prefill_bucket: int = 128,
        seed: int = 0,
        enable_prefix_cache: bool = True,
        draft_cfg=None,
        mesh=None,
        prefill_chunk: Optional[int] = None,
        log_every: int = 0,
        adapter=None,
        decode_burst: int = 1,
        enable_mixed: bool = True,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError("Engine(mesh=...): multi-device serving is not ported yet")
        if draft_cfg is not None:
            raise NotImplementedError("Engine(draft_cfg=...): speculative decoding is not ported yet")
        if decode_burst < 1:
            raise ValueError(f"Engine(decode_burst={decode_burst}): a burst is at least one step")
        self.device = resolve_device(device)
        self.adapter = adapter if adapter is not None else adapter_for(cfg, self.device)
        self.cfg = cfg
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq or cdiv(cfg.max_position, page_size)
        self.prefill_bucket = prefill_bucket
        # chunked prefill: prompts longer than prefill_chunk are ingested one
        # chunk per scheduler step through the extend path, so running
        # decodes are not stalled behind a whole prompt
        self.prefill_chunk = prefill_chunk
        self.enable_mixed = enable_mixed
        if params is None:
            params = self.adapter.init_weights(torch.Generator(device=self.device).manual_seed(seed))
        self.params = params
        self.rope_cache = self.adapter.rope_cache
        self.caches = self.adapter.make_caches(num_pages, page_size)
        # an adapter without an extend program can consume no cached prefix
        # and chunk no prompt
        if not getattr(self.adapter, "supports_extend", True):
            enable_prefix_cache = False
            if prefill_chunk is not None:
                raise ValueError(f"{self.adapter.name} has no extend program; prefill_chunk needs one")
        self.native = None
        if enable_prefix_cache:
            from .native import NativeAllocator

            self.native = NativeAllocator(num_pages, page_size)
        self.allocator = self.native if self.native is not None else PageAllocator(num_pages)
        self.waiting: List[Request] = []
        self.prefilling: List[Request] = []  # chunked prefills in flight
        self.running: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # decode steps: static inputs, and a graph per burst length (1 = the
        # plain step), as JAX jits one program per length (``_burst_fns``)
        self.decode_burst = decode_burst
        self._inputs = DecodeInputs(self.device, max_batch, self.max_pages_per_seq)
        self._graphs: Dict[int, DecodeGraph] = {}
        self._decode_pools = self.caches  # every program updates these in place
        self._eager_decode = False
        self.metrics = Metrics()
        self.log_every = log_every

    # ------------------------------------------------------------------
    def add_request(
        self,
        prompt: List[int],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_p: Optional[float] = None,
        stop_tokens=(),
        grammar=None,
    ) -> int:
        if grammar is not None:
            raise NotImplementedError("grammar-constrained decoding is not ported yet")
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(
            rid, list(prompt), max_new_tokens, temperature,
            top_k=top_k, top_p=top_p, min_p=min_p, stop_tokens=tuple(stop_tokens),
        ))
        return rid

    def _slot(self, req: Request, pos: int) -> int:
        return req.pages[pos // self.page_size] * self.page_size + pos % self.page_size

    def _page_table(self, req: Request) -> np.ndarray:
        pt = np.zeros(self.max_pages_per_seq, np.int32)
        pt[: len(req.pages)] = req.pages
        return pt

    def _batch_tables(self, reqs, bp: int) -> np.ndarray:
        """[bp, max_pages_per_seq] page tables, zero-padded; through the
        native library's ``assemble_tables`` when the prefix cache is on."""
        if self.native is not None:
            lists = [r.pages for r in reqs] + [[]] * (bp - len(reqs))
            return self.native.assemble_tables(lists, self.max_pages_per_seq)
        t = np.zeros((bp, self.max_pages_per_seq), np.int32)
        for i, r in enumerate(reqs):
            t[i, : len(r.pages)] = r.pages
        return t

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    def _decode_inputs(self, reqs, pad_length: int):
        """tokens, positions, lengths, slot_loc [max_batch] and page tables of
        a decode batch; padding rows have length ``pad_length`` and slot -1
        (as in the JAX engine: 0 in the decode step, 1 in the mixed step)."""
        bp = self.max_batch
        tokens = np.zeros(bp, np.int32)
        positions = np.zeros(bp, np.int32)
        lengths = np.full(bp, pad_length, np.int32)
        slot_loc = np.full(bp, -1, np.int32)
        for i, r in enumerate(reqs):
            pos = r.seq_len - 1  # position of the token being fed
            tokens[i] = r.output[-1] if r.output else r.prompt[-1]
            positions[i] = pos
            lengths[i] = r.seq_len
            slot_loc[i] = self._slot(r, pos)
        return tokens, positions, lengths, slot_loc, self._batch_tables(reqs, bp)

    # ------------------------------------------------------------------
    def _admit(self):
        batch: List[Request] = []  # fresh full prefills -> one packed launch
        while self.waiting and len(self.running) + len(self.prefilling) + len(batch) < self.max_batch:
            req = self.waiting[0]
            shared: List[int] = []
            if self.native is not None and len(req.prompt) > 1:
                # reuse the longest cached page-aligned prefix, keeping at
                # least one fresh token so prefill produces logits
                matched, shared, req.lock_id = self.native.match_prefix_locked(req.prompt[:-1])
                req.prefix_len = matched
                req.shared_pages = len(shared)
            need = cdiv(req.seq_len + req.max_new_tokens, self.page_size) - len(shared)
            pages = self.allocator.alloc(need)
            if pages is None and self.native is not None:
                # evict unpinned cached pages (LRU) back to the free list and
                # retry: retired requests' pages adopted by the cache would
                # otherwise starve new admissions
                self.metrics.inc("pages_evicted", self.native.evict(need - self.allocator.free))
                pages = self.allocator.alloc(need)
            if pages is None:
                if req.lock_id:
                    self.native.unlock(req.lock_id)
                    req.prefix_len = req.shared_pages = req.lock_id = 0
                self.metrics.inc("admission_blocked")
                break
            req.pages = shared + pages
            self.waiting.pop(0)
            self.metrics.inc("requests_admitted")
            self.metrics.inc("prefix_cache_hit_tokens", req.prefix_len)
            if self.prefill_chunk is not None and len(req.prompt) - req.prefix_len > self.prefill_chunk:
                # long prompt: one chunk per scheduler step
                req.prefill_pos = req.prefix_len
                self.prefilling.append(req)
            elif req.prefix_len == 0 and getattr(self.adapter, "prefill_packed", None) is not None:
                batch.append(req)  # packed multi-prompt launch below
            else:
                with self.metrics.time("prefill"):
                    self._prefill(req)
                self.metrics.inc("tokens_prefilled", len(req.prompt) - req.prefix_len)
                self.running.append(req)
        if batch:
            with self.metrics.time("prefill"):
                self._prefill_packed_batch(batch)
            self.metrics.inc("tokens_prefilled", sum(len(r.prompt) for r in batch))
            self.running.extend(batch)

    def _prefill_packed_batch(self, reqs: List[Request]):
        """Fresh prompts block-aligned packed into one model launch: padding
        below one block per prompt instead of bucket - len, one launch for
        all. The block count is padded to a power of two, the padding blocks
        pointing at an empty pseudo-sequence row (q_len 0)."""
        if len(reqs) == 1:
            self._prefill(reqs[0])
            return
        # +1 seq_meta row for the padding pseudo-sequence
        blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(
            [len(r.prompt) for r in reqs], self.max_batch + 1, self._PACK_BLOCK)
        tokens = np.zeros(tp, np.int32)
        positions = np.zeros(tp, np.int32)
        slot_loc = np.full(tp, -1, np.int32)
        last_idx = np.zeros(self.max_batch + 1, np.int32)
        for i, (r, t0) in enumerate(zip(reqs, tok0)):
            n = len(r.prompt)
            tokens[t0: t0 + n] = r.prompt
            positions[t0: t0 + n] = np.arange(n)
            slot_loc[t0: t0 + n] = [self._slot(r, p) for p in range(n)]
            last_idx[i] = t0 + n - 1
        logits, self.caches = self.adapter.prefill_packed(
            self.params, self.caches, *(self._dev(a) for a in (tokens, positions, blk_seq, blk_q0, seq_meta,
                                                               last_idx, slot_loc)), max_kvb=max_kvb)
        self._append_tokens(reqs, logits)

    def _prefill(self, req: Request):
        pre = req.prefix_len
        total = len(req.prompt)
        if self.prefill_chunk is not None:
            while total - pre > self.prefill_chunk:
                self._prefill_range(req, pre, pre + self.prefill_chunk)
                pre += self.prefill_chunk
        self._append_tokens([req], self._prefill_range(req, pre, total))

    def _advance_prefilling(self, skip=None):
        """One chunk of progress per chunked prefill, so this step's decode
        batch is not starved. ``skip``: a request the mixed step already
        advanced this step."""
        still = []
        for req in self.prefilling:
            if req is skip:
                still.append(req)
                continue
            total = len(req.prompt)
            end = min(req.prefill_pos + self.prefill_chunk, total)
            with self.metrics.time("prefill"):
                logits = self._prefill_range(req, req.prefill_pos, end)
            self.metrics.inc("tokens_prefilled", end - req.prefill_pos)
            req.prefill_pos = end
            if end == total:
                self._append_tokens([req], logits)
                self.running.append(req)
            else:
                still.append(req)
        self.prefilling = still

    def _prefill_range(self, req: Request, pre: int, end: int):
        """Prefill prompt tokens [pre, end) of one request, padded to a
        power-of-two bucket: the plain prefill from position 0, else the
        extend program over the cached positions [0, pre)."""
        s = end - pre
        bucket = max(self.prefill_bucket, 1 << (s - 1).bit_length())
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :s] = req.prompt[pre:end]
        positions = np.zeros((1, bucket), np.int32)
        positions[0, :s] = np.arange(pre, end)
        slot_loc = np.full((1, bucket), -1, np.int32)
        slot_loc[0, :s] = [self._slot(req, p) for p in range(pre, end)]
        if pre == 0:
            logits, self.caches = self.adapter.prefill(
                self.params, self.caches, self._dev(tokens), self._dev(positions),
                self._dev(np.array([s], np.int32)), self._dev(slot_loc))
        else:
            logits, self.caches = self.adapter.prefill_extend(
                self.params, self.caches, self._dev(tokens), self._dev(positions),
                self._dev(np.array([s], np.int32)), self._dev(np.array([end], np.int32)),
                self._dev(self._page_table(req)[None]), self._dev(slot_loc),
                prefix_max=cdiv(pre, self.page_size) * self.page_size)
        return logits

    def _append_tokens(self, reqs: List[Request], logits):
        """Pick each request's next token from its row of ``logits``: greedy
        rows by one batched argmax, the sampled rows by one ``sample_tokens``
        call with per-row temperature / top-k / top-p / min-p and the
        engine's generator; the picks and the finite flags come back in one
        host transfer. Rows whose logits are not all finite are counted in
        ``nonfinite_logits``."""
        rows = logits[: len(reqs)]
        picks = rows.argmax(-1)
        sampled = [i for i, r in enumerate(reqs) if r.temperature != 0.0]
        if sampled:
            at = torch.tensor(sampled, device=rows.device)
            rs = [reqs[i] for i in sampled]

            def per_row(vals):  # None: no sampled row asks for the filter
                return None if all(v is None for v in vals) else vals

            drawn = sample_tokens(
                rows.index_select(0, at), self._gen, temperature=[r.temperature for r in rs],
                top_k=per_row([r.top_k for r in rs]), top_p=per_row([r.top_p for r in rs]),
                min_p=per_row([r.min_p for r in rs]))
            picks = picks.index_copy(0, at, drawn.to(picks.dtype))
        picked = torch.stack([picks, torch.isfinite(rows).all(-1).long()]).cpu()
        self.metrics.inc("nonfinite_logits", int((picked[1] == 0).sum()))
        for req, tok in zip(reqs, picked[0].tolist()):
            req.output.append(tok)
            if len(req.output) >= req.max_new_tokens or tok in req.stop_tokens:
                req.done = True

    def _decode_graph(self, burst: int) -> DecodeGraph:
        """The decode program of ``burst`` steps over the static inputs (a
        graph on the card, captured at its first call). ``burst`` 1 gives
        the step's logits [max_batch, V]; more gives [max_batch, burst + 1]
        int32: each step's argmax, fed back as the next step's token, then 1
        where every step's logits were finite. Between steps positions and
        lengths advance by one and slot_loc is looked up in the page tables
        (padding rows, slot -1, stay -1), as JAX's scan body does
        (sgl_kernel_tpu/serving/engine.py:593-609)."""
        if burst in self._graphs:
            return self._graphs[burst]
        adapter, params, caches, page = self.adapter, self.params, self.caches, self.page_size

        def step(tokens, positions, tables, lengths, slot_loc):
            logits, out = adapter.decode(params, caches, tokens, positions, tables, lengths, slot_loc)
            if any(a is not b for a, b in zip(out, caches)):
                raise RuntimeError(f"{adapter.name}: decode must update the pools in place")
            return logits

        def steps(tokens, positions, tables, lengths, slot_loc):
            rows = torch.arange(tables.shape[0], device=tables.device)
            toks, finite = [], True
            for _ in range(burst):
                logits = step(tokens, positions, tables, lengths, slot_loc)
                tokens = logits.argmax(-1).to(torch.int32)
                finite = torch.isfinite(logits).all(-1) & finite
                toks.append(tokens)
                positions, lengths = positions + 1, lengths + 1
                col = (positions // page).clamp_max(tables.shape[1] - 1).long()
                slot_loc = torch.where(slot_loc >= 0, tables[rows, col] * page + positions % page, -1)
            return torch.stack(toks + [finite.to(torch.int32)], dim=1)

        graph = self._graphs[burst] = DecodeGraph(step if burst == 1 else steps, self._inputs)
        return graph

    def _run_decode(self, reqs, burst: int, pad_length: int):
        """Fill the static inputs from ``reqs`` and run the ``burst``-step
        program: a graph replay on the card unless ``_eager_decode``."""
        if any(a is not b for a, b in zip(self.caches, self._decode_pools)):
            raise RuntimeError("Engine: the KV pools moved; the decode graphs hold their addresses")
        self._inputs.fill(*self._decode_inputs(reqs, pad_length))
        graph = self._decode_graph(burst)
        replays = graph.replays
        out = graph(eager=self._eager_decode)
        self.metrics.inc("decode_graph_replays", graph.replays - replays)
        return out

    def _decode_batch(self):
        reqs = [r for r in self.running if not r.done]
        if not reqs:
            return
        if self.decode_burst > 1 and all(r.temperature == 0.0 for r in reqs):
            burst = min(self.decode_burst, min(r.max_new_tokens - len(r.output) for r in reqs))
            if burst > 1:
                return self._decode_burst_batch(reqs, burst)
        self._append_tokens(reqs, self._run_decode(reqs, 1, 0))
        self.metrics.inc("tokens_decoded", len(reqs))
        self.metrics.set_gauge("decode_batch", len(reqs))

    def _decode_burst_batch(self, reqs, burst: int):
        """``burst`` greedy steps in one program (padding rows length 1, as
        JAX's ``_decode_burst_batch``); a request keeps its tokens up to and
        including a stop token, and its pages hold the KV of the discarded
        rest until it retires."""
        out = self._run_decode(reqs, burst, 1)[: len(reqs)].cpu()
        self.metrics.inc("nonfinite_logits", int((out[:, burst] == 0).sum()))
        for r, toks in zip(reqs, out[:, :burst].tolist()):
            for t in toks:
                r.output.append(t)
                self.metrics.inc("tokens_decoded")
                if t in r.stop_tokens:
                    r.done = True
                    break
            if len(r.output) >= r.max_new_tokens:
                r.done = True
        self.metrics.set_gauge("decode_batch", len(reqs))

    def _try_mixed_step(self):
        """Fuse the first in-flight prefill chunk with this step's decode
        batch into one ``mixed_step``. Returns the prefill Request it
        advanced (the caller skips it in ``_advance_prefilling``), or None
        when the plain path should run."""
        if not self.enable_mixed or not self.prefilling or self.decode_burst > 1:
            return None
        if not hasattr(getattr(self.adapter, "_m", None), "mixed_step"):
            return None
        reqs = [r for r in self.running if not r.done]
        if not reqs:
            return None
        pf = self.prefilling[0]
        pre = pf.prefill_pos
        if pre == 0:
            return None  # the first chunk has no cached prefix: plain path
        total = len(pf.prompt)
        end = min(pre + self.prefill_chunk, total)
        s = end - pre
        bucket = max(self.prefill_bucket, 1 << (s - 1).bit_length())
        pf_tokens = np.zeros(bucket, np.int32)
        pf_tokens[:s] = pf.prompt[pre:end]
        pf_positions = np.zeros(bucket, np.int32)
        pf_positions[:s] = np.arange(pre, end)
        pf_slots = np.full(bucket, -1, np.int32)
        pf_slots[:s] = [self._slot(pf, p) for p in range(pre, end)]
        tokens, positions, lengths, slot_loc, tables = self._decode_inputs(reqs, 1)
        k, v = self.caches
        with self.metrics.time("mixed"):
            dec_logits, pf_logits, k, v = self.adapter._m.mixed_step(
                self.params, self.cfg, k, v,
                *(self._dev(a) for a in (tokens, positions, tables, lengths, slot_loc, pf_tokens, pf_positions)),
                s, end, self._dev(self._page_table(pf)), self._dev(pf_slots), self.rope_cache,
                prefix_max=cdiv(pre, self.page_size) * self.page_size)
            self.caches = (k, v)
            self._append_tokens(reqs, dec_logits)
        self.metrics.inc("tokens_decoded", len(reqs))
        self.metrics.inc("tokens_prefilled", s)
        self.metrics.inc("mixed_steps")
        pf.prefill_pos = end
        if end == total:
            self.prefilling.remove(pf)
            self._append_tokens([pf], pf_logits[None])
            self.running.append(pf)
        return pf

    def _retire(self):
        still = []
        for r in self.running:
            if not r.done:
                still.append(r)
                continue
            if self.native is not None:
                seq = r.prompt + r.output
                # the last emitted token was never fed through the model, so
                # its slot holds no KV: only positions [0, len(seq) - 1) are
                # valid, and a page holding that slot must not be cached
                full_pages = (len(seq) - 1) // self.page_size
                adopted = 0
                if full_pages > 0:
                    adopted = self.native.insert_prefix(seq[: full_pages * self.page_size], r.pages[:full_pages])
                # ownership: pages[:shared_pages] were the cache's already; the
                # adopted tail of the full-page range is the cache's now;
                # everything else returns to the free list
                keep = set(range(r.shared_pages)) | set(range(full_pages - adopted, full_pages))
                release = [p for i, p in enumerate(r.pages) if i not in keep]
                if release:
                    self.allocator.release(release)
                if r.lock_id:
                    self.native.unlock(r.lock_id)
                    r.lock_id = 0
            else:
                self.allocator.release(r.pages)
            r.pages = []
            self.finished[r.rid] = r
            self.metrics.inc("requests_finished")
        self.running = still

    # ------------------------------------------------------------------
    def step(self):
        """One scheduler iteration: admit and prefill, the mixed step or the
        chunk advances and one decode step, retire."""
        with self.metrics.time("step"):
            self._admit()
            mixed_pf = self._try_mixed_step()  # the Request served fused, or None
            self._advance_prefilling(skip=mixed_pf)
            if mixed_pf is None:
                # timed only here: a fused step must not log a ~0 "decode"
                # sample
                with self.metrics.time("decode"):
                    self._decode_batch()
            self._retire()
        self.metrics.inc("scheduler_steps")
        free = self.allocator.free  # int (native) or the free list
        self.metrics.set_gauge("free_pages", free if isinstance(free, int) else len(free))
        self.metrics.set_gauge("running", len(self.running))
        self.metrics.set_gauge("waiting", len(self.waiting))
        if self.log_every and self.metrics.counters["scheduler_steps"] % self.log_every == 0:
            logger.info(self.metrics.log_line())

    def run_until_done(self, max_steps: int = 10_000):
        steps = 0
        while (self.waiting or self.prefilling or self.running) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
