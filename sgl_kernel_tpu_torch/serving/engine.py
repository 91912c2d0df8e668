"""Continuous-batching serving engine.

A paged-KV page allocator (free list), a prefill/decode scheduler, and a
step loop that feeds the model adapter's prefill and decode programs. Each
scheduler step admits waiting requests while the batch has room (each
fresh prompt prefilled on its own, padded to a power-of-two bucket), runs
one decode step over the running batch padded to ``max_batch``, and
retires finished requests, whose pages return to the free list.

This slice serves fresh prompts and the plain decode step. Prefix reuse,
chunked and packed prefill, speculative decoding, decode bursts, grammars
and a device mesh are later slices: the arguments that ask for them raise
``NotImplementedError``.
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

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + len(self.output)


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
    runs the plain PyTorch versions."""

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
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError("Engine(mesh=...): multi-device serving is not ported yet")
        if draft_cfg is not None:
            raise NotImplementedError("Engine(draft_cfg=...): speculative decoding is not ported yet")
        if decode_burst != 1:
            raise NotImplementedError("Engine(decode_burst>1): decode bursts are not ported yet")
        if prefill_chunk is not None:
            raise NotImplementedError("Engine(prefill_chunk=...): chunked prefill is not ported yet")
        self.device = resolve_device(device)
        self.adapter = adapter if adapter is not None else adapter_for(cfg, self.device)
        self.cfg = cfg
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq or cdiv(cfg.max_position, page_size)
        self.prefill_bucket = prefill_bucket
        if params is None:
            params = self.adapter.init_weights(torch.Generator(device=self.device).manual_seed(seed))
        self.params = params
        self.rope_cache = self.adapter.rope_cache
        self.caches = self.adapter.make_caches(num_pages, page_size)
        # an adapter without an extend program cannot consume a cached
        # prefix, so the prefix cache is off (as the JAX engine does)
        if enable_prefix_cache and getattr(self.adapter, "supports_extend", True):
            raise NotImplementedError("prefix caching needs an extend-prefill adapter, not ported yet")
        self.allocator = PageAllocator(num_pages)
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
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

    def _batch_tables(self, reqs, bp: int) -> np.ndarray:
        t = np.zeros((bp, self.max_pages_per_seq), np.int32)
        for i, r in enumerate(reqs):
            t[i, : len(r.pages)] = r.pages
        return t

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    def _admit(self):
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            need = cdiv(req.seq_len + req.max_new_tokens, self.page_size)
            pages = self.allocator.alloc(need)
            if pages is None:
                self.metrics.inc("admission_blocked")
                break
            req.pages = pages
            self.waiting.pop(0)
            self.metrics.inc("requests_admitted")
            with self.metrics.time("prefill"):
                self._prefill(req)
            self.metrics.inc("tokens_prefilled", len(req.prompt))
            self.running.append(req)

    def _prefill(self, req: Request):
        logits = self._prefill_range(req, 0, len(req.prompt))
        self._append_tokens([req], logits)

    def _prefill_range(self, req: Request, pre: int, end: int):
        if pre != 0:
            raise NotImplementedError("extend prefill (a cached prefix) is not ported yet")
        s = end - pre
        bucket = max(self.prefill_bucket, 1 << (s - 1).bit_length())
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :s] = req.prompt[pre:end]
        positions = np.zeros((1, bucket), np.int32)
        positions[0, :s] = np.arange(pre, pre + s)
        slot_loc = np.full((1, bucket), -1, np.int32)
        slot_loc[0, :s] = [self._slot(req, p) for p in range(pre, end)]
        logits, self.caches = self.adapter.prefill(
            self.params, self.caches, self._dev(tokens), self._dev(positions),
            self._dev(np.array([s], np.int32)), self._dev(slot_loc))
        return logits

    def _append_tokens(self, reqs: List[Request], logits):
        """Pick each request's next token from its row of ``logits``: greedy
        rows by one batched argmax (one host transfer), sampled rows through
        ``sample_tokens`` with the engine's generator. Rows whose logits are
        not all finite are counted in ``nonfinite_logits``."""
        rows = logits[: len(reqs)]
        picked = torch.stack([rows.argmax(-1), torch.isfinite(rows).all(-1).long()]).cpu()
        self.metrics.inc("nonfinite_logits", int((picked[1] == 0).sum()))
        for i, req in enumerate(reqs):
            if req.temperature == 0.0:
                tok = int(picked[0, i])
            else:
                tok = int(sample_tokens(
                    rows[i: i + 1], self._gen, temperature=req.temperature,
                    top_k=None if req.top_k is None else [req.top_k],
                    top_p=None if req.top_p is None else [req.top_p],
                    min_p=None if req.min_p is None else [req.min_p],
                )[0])
            req.output.append(tok)
            if len(req.output) >= req.max_new_tokens or tok in req.stop_tokens:
                req.done = True

    def _decode_batch(self):
        reqs = [r for r in self.running if not r.done]
        if not reqs:
            return
        b = len(reqs)
        bp = self.max_batch  # padded to a fixed batch; pad rows have length 0, slot -1
        tokens = np.zeros(bp, np.int32)
        positions = np.zeros(bp, np.int32)
        lengths = np.zeros(bp, np.int32)
        slot_loc = np.full(bp, -1, np.int32)
        tables = self._batch_tables(reqs, bp)
        for i, r in enumerate(reqs):
            pos = r.seq_len - 1  # position of the token being fed
            tokens[i] = r.output[-1] if r.output else r.prompt[-1]
            positions[i] = pos
            lengths[i] = r.seq_len
            slot_loc[i] = self._slot(r, pos)
        logits, self.caches = self.adapter.decode(
            self.params, self.caches, self._dev(tokens), self._dev(positions),
            self._dev(tables), self._dev(lengths), self._dev(slot_loc))
        self._append_tokens(reqs, logits)
        self.metrics.inc("tokens_decoded", b)
        self.metrics.set_gauge("decode_batch", b)

    def _retire(self):
        still = []
        for r in self.running:
            if not r.done:
                still.append(r)
                continue
            self.allocator.release(r.pages)
            r.pages = []
            self.finished[r.rid] = r
            self.metrics.inc("requests_finished")
        self.running = still

    # ------------------------------------------------------------------
    def step(self):
        """One scheduler iteration: admit+prefill, one decode step, retire."""
        with self.metrics.time("step"):
            self._admit()
            with self.metrics.time("decode"):
                self._decode_batch()
            self._retire()
        self.metrics.inc("scheduler_steps")
        self.metrics.set_gauge("free_pages", len(self.allocator.free))
        self.metrics.set_gauge("running", len(self.running))
        self.metrics.set_gauge("waiting", len(self.waiting))
        if self.log_every and self.metrics.counters["scheduler_steps"] % self.log_every == 0:
            logger.info(self.metrics.log_line())

    def run_until_done(self, max_steps: int = 10_000):
        steps = 0
        while (self.waiting or self.running) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
