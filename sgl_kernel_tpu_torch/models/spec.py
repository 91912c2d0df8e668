"""Speculative decoding rounds: a Llama-family draft proposes, the target
verifies.

The port of ``sgl_kernel_tpu/models/spec.py``. A chain round
(``spec_decode_round``) runs gamma greedy draft decode steps, one verify
extend of the target over the gamma + 1 tokens with ``num_logits=gamma+1``,
and keeps the leading run of drafts the target's argmax agrees with, then
the target's own next token (the bonus). A tree round (``spec_tree_round``,
Llama targets: ``llama.prefill_tree``) keeps each draft step's top-k as
sibling nodes of the spine, verifies the whole tree in one tree-masked
forward, walks it with ``verify_tree_greedy``, moves the accepted nodes'
target rows to their position slots (``move_cache_rows_stacked``) and
rewrites the draft's rows by one extend over the accepted tokens. Greedy
speculation is lossless: only the target decides the tokens.

Cache bookkeeping is rollback by overwrite, as in JAX: rows past the
accepted length are rewritten at the same slots in a later round. At a
round's start both caches hold the rows of positions [0, L - 1). The chain
round feeds the draft positions L-1 .. L+gamma-2 only, so after a full
acceptance the draft's row at L+gamma-1 is one it never wrote (zeros in a
fresh pool) until a later round writes it: acceptance then falls below
100 % even with draft = target, as in JAX; the output does not change.

The rounds' own steps read nothing back to the host (the extend's KV
store does, as every prefill's). The functions here are eager; the engine
runs the chain's draft steps as one captured graph (``Engine._draft_rollout``,
the same body as a ``decode_burst`` program).
"""

from __future__ import annotations

import torch

from ..ops.kvcache import move_cache_rows_stacked
from ..ops.speculative import build_tree_kernel_efficient, verify_tree_greedy
from . import llama


def _slots(page_tables, positions, page_size: int):
    """Flat cache slots of ``positions`` [B, n] in ``page_tables`` [B, P]."""
    pos = positions.long()
    col = (pos // page_size).clamp(0, page_tables.shape[1] - 1)
    return page_tables.long().gather(1, col) * page_size + pos % page_size


def _top_k(logits, k: int):
    """Indices [B, k] of each row's k largest logits, largest first, ties to
    the lower index (``jax.lax.top_k``'s order; ``argmax``'s for k = 1)."""
    if k == 1:
        return logits.argmax(-1, keepdim=True)
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


def draft_rollout(params_d, cfg_d, kcd, vcd, last_tok, lengths, page_tables, rope_d, valid, *, gamma: int,
                  topk: int = 1):
    """``gamma`` greedy decode steps of the draft from ``last_tok`` at
    position L - 1 (L = ``lengths``): step i feeds position L - 1 + i and the
    spine token of step i - 1; rows not ``valid`` store nothing. Returns
    (tops [B, gamma, topk] int32, each step's top-k with the spine token
    first; kcd, vcd; finite [B], whether every step's logits were finite)."""
    page = kcd.shape[-2]
    lengths = lengths.to(torch.int32)
    tok, tops, finite = last_tok.to(torch.int32), [], torch.ones_like(valid, dtype=torch.bool)
    for i in range(gamma):
        pos = lengths - 1 + i
        sl = torch.where(valid, _slots(page_tables, pos[:, None], page)[:, 0], -1).to(torch.int32)
        logits, kcd, vcd = llama.decode_step(params_d, cfg_d, kcd, vcd, tok, pos, page_tables, pos + 1, sl, rope_d)
        top = _top_k(logits, topk).to(torch.int32)
        finite = finite & torch.isfinite(logits).all(-1)
        tok = top[:, 0]
        tops.append(top)
    return torch.stack(tops, dim=1), kcd, vcd, finite


def verify_chain(extend, last_tok, drafts, lengths, page_tables, valid, *, gamma: int, page_size: int,
                 prefix_max: int):
    """The target's verify of a chain: one extend of [last_tok, drafts] at
    positions L - 1 .. L + gamma - 1 with ``num_logits=gamma+1``, then the
    leading run of drafts equal to the target's argmax and the bonus token
    after it. ``extend(tokens, positions, q_lens, kv_lens, page_tables,
    slot_loc, *, prefix_max, num_logits)`` is the target's extend over its
    caches, returning (logits, caches): an adapter's ``prefill_extend`` with
    its params and caches bound. Returns (new_tokens [B, gamma+1] int32,
    n_new [B] int32: a row appends new_tokens[:n_new]; caches; finite [B],
    whether the row's logits were all finite)."""
    b = last_tok.shape[0]
    dev = last_tok.device
    lengths = lengths.to(torch.int32)
    ar = torch.arange(gamma + 1, device=dev, dtype=torch.int32)
    q_tokens = torch.cat([last_tok.to(torch.int32)[:, None], drafts.to(torch.int32)], dim=1)
    positions = lengths[:, None] - 1 + ar[None, :]
    slot_loc = torch.where(valid[:, None], _slots(page_tables, positions, page_size), -1).to(torch.int32)
    logits_all, caches = extend(q_tokens, positions, torch.full((b,), gamma + 1, dtype=torch.int32, device=dev),
                                lengths + gamma, page_tables, slot_loc, prefix_max=prefix_max, num_logits=gamma + 1)
    greedy = logits_all.argmax(-1).to(torch.int32)  # [B, gamma+1]
    match = (drafts.to(torch.int32) == greedy[:, :gamma]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(1)  # the leading run
    bonus = greedy.gather(1, n_acc[:, None].long())[:, 0]
    padded = torch.cat([drafts.to(torch.int32), torch.zeros_like(bonus)[:, None]], dim=1)
    new_tokens = torch.where(ar[None, :] < n_acc[:, None], padded, bonus[:, None])
    finite = torch.isfinite(logits_all).flatten(1).all(-1)
    return new_tokens, (n_acc + 1).to(torch.int32), caches, finite


def spec_decode_round(params_t, params_d, caches_t, kcd, vcd, last_tok, lengths, page_tables, rope_t, rope_d,
                      valid=None, *, cfg_t, cfg_d, target=None, gamma: int, prefix_max: int):
    """One chain round for a decode batch (spec.py:38-111). last_tok [B]:
    each sequence's newest token (not yet fed); lengths [B]: L, tokens
    including it; page_tables [B, P]; valid [B] bool, rows whose writes are
    kept (padding rows are not). ``caches_t`` is the target family's caches
    tuple ((k, v) for Llama and Mixtral, (latent,) for DeepSeek), splatted
    into ``target.prefill_extend`` (``target`` a model module, default
    llama). Returns (new_tokens [B, gamma+1], n_new [B], caches_t, kcd,
    vcd): sequence i appends new_tokens[i, :n_new[i]]. The pools are
    updated in place."""
    if valid is None:
        valid = torch.ones(last_tok.shape[0], dtype=torch.bool, device=last_tok.device)
    tops, kcd, vcd, _ = draft_rollout(params_d, cfg_d, kcd, vcd, last_tok, lengths, page_tables, rope_d, valid,
                                      gamma=gamma)
    tmod = target if target is not None else llama

    def extend(*args, **kw):  # the module's calling convention: caches splatted, rope after slot_loc
        out = tmod.prefill_extend(params_t, cfg_t, *caches_t, *args, rope_t, **kw)
        return out[0], tuple(out[1:])

    new_tokens, n_new, caches_t, _ = verify_chain(extend, last_tok, tops[:, :, 0], lengths, page_tables, valid,
                                                  gamma=gamma, page_size=kcd.shape[-2], prefix_max=prefix_max)
    return new_tokens, n_new, caches_t, kcd, vcd


def tree_round(params_t, params_d, kct, vct, kcd, vcd, last_tok, lengths, page_tables, rope_t, rope_d, valid, *,
               cfg_t, cfg_d, gamma: int, topk: int, prefix_max: int):
    """``spec_tree_round``'s work, returning its outputs and finite [B]:
    whether the row's draft and tree logits were all finite."""
    b = last_tok.shape[0]
    dev = last_tok.device
    page = kcd.shape[-2]
    dt = 1 + gamma * topk
    lengths = lengths.to(torch.int32)
    last_tok = last_tok.to(torch.int32)

    # the draft's chain rollout, keeping each step's top-k
    tops, kcd, vcd, finite_d = draft_rollout(params_d, cfg_d, kcd, vcd, last_tok, lengths, page_tables, rope_d,
                                             valid, gamma=gamma, topk=topk)

    # level i's topk nodes are children of level i-1's spine node (candidate
    # (i-1)*topk); level 0 hangs off the root
    candidates = torch.cat([last_tok[:, None], tops.reshape(b, gamma * topk)], dim=1)
    lvl = torch.arange(gamma, device=dev).repeat_interleave(topk)
    parent_c = torch.where(lvl == 0, -1, (lvl - 1) * topk)
    parent_list = parent_c[None].expand(b, gamma * topk)
    selected_index = torch.arange(gamma * topk, device=dev)[None].expand(b, gamma * topk)
    tree_mask, positions, ridx, nxt, sib = build_tree_kernel_efficient(
        parent_list, selected_index, lengths - 1, depth=gamma, draft_token_num=dt)

    # one tree-masked target forward, K/V written at per-node slots
    ar_dt = torch.arange(dt, device=dev, dtype=torch.int32)
    node_pos = lengths[:, None] - 1 + ar_dt[None, :]
    slot_nodes = torch.where(valid[:, None], _slots(page_tables, node_pos, page), -1).to(torch.int32)
    logits_all, kct, vct = llama.prefill_tree(params_t, cfg_t, kct, vct, candidates, positions, tree_mask,
                                              lengths - 1, page_tables, slot_nodes, rope_t, prefix_max=prefix_max)
    target_predict = logits_all.argmax(-1).to(torch.int32)  # [B, dt]
    preds_flat, accept_index, accept_num = verify_tree_greedy(candidates, ridx, nxt, sib, target_predict,
                                                              num_spec_step=gamma + 1)
    n_new = accept_num + 1
    # the emitted tokens: the target's prediction at each accepted node
    acc_ok = accept_index >= 0  # [B, gamma+1]
    new_tokens = preds_flat[accept_index.clamp_min(0).reshape(-1).long()].reshape(b, gamma + 1)
    last_new = new_tokens.gather(1, (n_new - 1)[:, None].long())[:, 0]
    new_tokens = torch.where(acc_ok, new_tokens, last_new[:, None])

    # target fix-up: accepted node j's row -> the slot of position L-1+j
    ar_g = torch.arange(gamma + 1, device=dev, dtype=torch.int32)
    acc_node = accept_index.clamp_min(0) - torch.arange(b, device=dev, dtype=torch.int32)[:, None] * dt
    src_sl = _slots(page_tables, lengths[:, None] - 1 + acc_node, page)
    dst_pos = lengths[:, None] - 1 + ar_g[None, :]
    dst_sl = torch.where(acc_ok & valid[:, None] & (acc_node != ar_g[None, :]), _slots(page_tables, dst_pos, page), -1)
    kct, vct = move_cache_rows_stacked(kct, vct, src_sl.reshape(-1), dst_sl.reshape(-1))

    # draft fix-up: one extend over the accepted path restores the rows at
    # positions L-1 .. L+gamma-1 ([root, emitted[:-1]])
    fix_tokens = torch.cat([last_tok[:, None], new_tokens[:, :gamma]], dim=1)
    dslots = torch.where(valid[:, None], _slots(page_tables, dst_pos, page), -1).to(torch.int32)
    _, kcd, vcd = llama.prefill_extend(
        params_d, cfg_d, kcd, vcd, fix_tokens, dst_pos,
        q_lens=torch.full((b,), gamma + 1, dtype=torch.int32, device=dev), kv_lens=lengths + gamma,
        page_tables=page_tables, slot_loc=dslots, rope_cache=rope_d, prefix_max=prefix_max)
    finite = finite_d & torch.isfinite(logits_all).flatten(1).all(-1)
    return new_tokens.to(torch.int32), n_new.to(torch.int32), kct, vct, kcd, vcd, finite


def spec_tree_round(params_t, params_d, kct, vct, kcd, vcd, last_tok, lengths, page_tables, rope_t, rope_d,
                    valid=None, *, cfg_t, cfg_d, gamma: int, topk: int, prefix_max: int):
    """One tree round for a Llama target (spec.py:119-233): the draft rolls
    one greedy chain of ``gamma`` steps and each step's top-``topk`` tokens
    become sibling nodes, dt = 1 + gamma * topk nodes; the target verifies
    the tree in one ``llama.prefill_tree`` (its K/V at per-node slots, L - 1
    onwards) and ``verify_tree_greedy`` walks it. Then the accepted nodes'
    rows move to their position slots and one draft extend over the
    accepted tokens rewrites the draft's rows. Returns (new_tokens [B,
    gamma+1], n_new [B], kct, vct, kcd, vcd); the pools are updated in
    place."""
    if valid is None:
        valid = torch.ones(last_tok.shape[0], dtype=torch.bool, device=last_tok.device)
    return tree_round(params_t, params_d, kct, vct, kcd, vcd, last_tok, lengths, page_tables, rope_t, rope_d,
                      valid, cfg_t=cfg_t, cfg_d=cfg_d, gamma=gamma, topk=topk, prefix_max=prefix_max)[:6]
