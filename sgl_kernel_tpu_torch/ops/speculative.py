"""Speculative decoding helpers: tree verification, tree sampling, bit
packing and the draft tree's metadata.

The port of ``sgl_kernel_tpu/ops/speculative.py`` (no Pallas kernel there:
the walks are ``lax.while_loop`` / ``fori_loop`` under ``vmap``), with the
same contract and the same linked-list encoding of a tree: per batch row,
``retrive_next_token[node]`` is the first child, ``retrive_next_sibling[node]``
the next sibling, ``candidates[node]`` the draft token and
``retrive_index[node]`` the node's row in the flat predicts buffer.

Here every row walks at once, as tensor operations with fixed trip counts:
``num_spec_step`` levels, and at each level at most ``num_draft`` siblings
(a tree has at most that many nodes). Nothing reads a value back to the
host, so a walk runs on the card without a sync per node. A row whose walk
ended keeps its state, as the JAX loops' finished lanes do.
"""

from __future__ import annotations

import torch


def _walk_children(cand, nxt, sib, parent, accept_fn, state):
    """The sibling list of each row's ``parent`` [B], walked in order until
    ``accept_fn(node, token, active, state) -> (ok, state)`` accepts a node:
    returns (accepted node or -1, state). ``cand`` / ``nxt`` / ``sib`` [B, nd]."""
    b, nd = cand.shape
    node = nxt.gather(1, parent.clamp_min(0)[:, None])[:, 0]
    accepted = torch.full_like(node, -1)
    for _ in range(nd):  # a list holds at most nd nodes
        active = (node >= 0) & (accepted < 0)
        safe = node.clamp_min(0)[:, None]
        ok, state = accept_fn(safe[:, 0], cand.gather(1, safe)[:, 0], active, state)
        ok = ok & active
        accepted = torch.where(ok, node, accepted)
        node = torch.where(active & ~ok, sib.gather(1, safe)[:, 0], node)
    return accepted, state


def _scatter_flat(retrive_index, preds, total: int):
    """preds [B, nd] into a flat [total] buffer at retrive_index, -1
    elsewhere; indices outside [0, total) are dropped."""
    idx = retrive_index.reshape(-1).long()
    idx = torch.where((idx >= 0) & (idx < total), idx, total)
    flat = torch.full((total + 1,), -1, dtype=torch.int32, device=preds.device)
    flat.scatter_(0, idx, preds.reshape(-1).to(torch.int32))
    return flat[:total]


def verify_tree_greedy(candidates, retrive_index, retrive_next_token, retrive_next_sibling, target_predict,
                       num_spec_step: int):
    """Greedy tree verification. candidates / retrive_* / target_predict
    [B, num_draft]. From the root, each level records the node in
    ``accept_index``, predicts ``target_predict`` there, and moves to the
    child whose candidate equals that prediction (a child found at the last
    level has no slot left and is not counted). Returns (predicts
    [B*num_draft] int32 flat via retrive_index, accept_index [B,
    num_spec_step], accept_token_num [B])."""
    b, nd = candidates.shape
    dev = candidates.device
    cand, ridx = candidates.long(), retrive_index.long()
    nxt, sib, tpred = retrive_next_token.long(), retrive_next_sibling.long(), target_predict.long()
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    count = torch.zeros(b, dtype=torch.long, device=dev)
    preds = torch.full((b, nd), -1, dtype=torch.long, device=dev)
    accept = torch.full((b, num_spec_step), -1, dtype=torch.long, device=dev)
    for i in range(num_spec_step):
        live = cur >= 0
        c = cur.clamp_min(0)[:, None]
        accept[:, i] = torch.where(live, ridx.gather(1, c)[:, 0], accept[:, i])
        tok = tpred.gather(1, c)[:, 0]
        preds.scatter_(1, c, torch.where(live, tok, preds.gather(1, c)[:, 0])[:, None])
        child, _ = _walk_children(cand, nxt, sib, cur, lambda node, t, active, st: (t == tok, st), None)
        last = i + 1 >= num_spec_step
        if not last:
            count = torch.where(live & (child >= 0), count + 1, count)
        cur = torch.where(live, torch.full_like(cur, -1) if last else child, cur)
    return (_scatter_flat(retrive_index, preds, b * nd), accept.to(torch.int32), count.to(torch.int32))


def tree_speculative_sampling_target_only(candidates, retrive_index, retrive_next_token, retrive_next_sibling,
                                          uniform_samples, target_probs, draft_probs, num_spec_step: int,
                                          threshold_single: float = 1.0, threshold_acc: float = 1.0,
                                          deterministic: bool = True):
    """Tree rejection sampling against the target distribution.
    target_probs / draft_probs [B, num_draft, V]; uniform_samples [B,
    num_draft]. At each node the children are tried in sibling order: a
    child is accepted when its target probability reaches
    ``threshold_single`` or the mass of the children tried so far reaches
    ``threshold_acc`` (and, unless ``deterministic``, when its coin falls
    under p / q; each rejection then takes the draft's mass off the residual
    target distribution, renormalized). A node with no accepted child
    predicts the target's argmax (deterministic) or an inverse-CDF sample of
    the residual with its own coin. Returns (predicts flat [B*num_draft],
    accept_index [B, num_spec_step], accept_num [B])."""
    b, nd, v = target_probs.shape
    dev = candidates.device
    cand, ridx = candidates.long(), retrive_index.long()
    nxt, sib = retrive_next_token.long(), retrive_next_sibling.long()
    coins = uniform_samples.float()
    rows = torch.arange(b, device=dev)
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    count = torch.zeros(b, dtype=torch.long, device=dev)
    preds = torch.full((b, nd), -1, dtype=torch.long, device=dev)
    accept = torch.full((b, num_spec_step), -1, dtype=torch.long, device=dev)

    for i in range(num_spec_step):
        live = cur >= 0
        c = cur.clamp_min(0)
        accept[:, i] = torch.where(live, ridx.gather(1, c[:, None])[:, 0], accept[:, i])
        q_d = draft_probs[rows, c].float()  # [B, V]
        tp = target_probs[rows, c].float()

        def try_child(node, tok, active, st):
            acc_p, res = st
            p_t = res.gather(1, tok[:, None])[:, 0]
            acc_p = torch.where(active, acc_p + p_t, acc_p)
            ok = (p_t >= threshold_single) | (acc_p >= threshold_acc)
            if not deterministic:
                p_d = q_d.gather(1, tok[:, None])[:, 0]
                ratio = torch.where(p_d > 0, p_t / torch.clamp_min(p_d, 1e-20),
                                    torch.where(p_t > 0, 1.0, 0.0))
                ok = ok | (coins.gather(1, node[:, None])[:, 0] < ratio)
                new_res = torch.clamp_min(res - q_d, 0.0)
                new_res = new_res / torch.clamp_min(new_res.sum(-1, keepdim=True), 1e-20)
                res = torch.where((active & ~ok)[:, None], new_res, res)
            return ok, (acc_p, res)

        child, (_, res) = _walk_children(cand, nxt, sib, cur, try_child,
                                         (torch.zeros(b, device=dev), tp))
        if deterministic:
            final_tok = tp.argmax(-1)
        else:
            csum = torch.cumsum(res, -1)
            u = coins.gather(1, c[:, None])[:, 0] * torch.clamp_min(csum[:, -1], 1e-20)
            final_tok = (csum < u[:, None]).sum(-1).clamp(0, v - 1)
        tok = torch.where(child >= 0, cand.gather(1, child.clamp_min(0)[:, None])[:, 0], final_tok)
        preds.scatter_(1, c[:, None], torch.where(live, tok, preds.gather(1, c[:, None])[:, 0])[:, None])
        last = i + 1 >= num_spec_step
        if not last:
            count = torch.where(live & (child >= 0), count + 1, count)
        cur = torch.where(live, torch.full_like(cur, -1) if last else child, cur)
    return (_scatter_flat(retrive_index, preds, b * nd), accept.to(torch.int32), count.to(torch.int32))


def segment_packbits(x, input_indptr, output_indptr, out_size: int):
    """Pack ragged boolean segments into bitfields (uint8), little-endian
    within each byte, each segment starting at its output_indptr byte.
    Bytes outside [0, out_size) are dropped; overlapping writes add modulo
    256, as the JAX scatter-add on uint8 does."""
    n = x.shape[0]
    dev = x.device
    ar = torch.arange(n, device=dev)
    seg_id = torch.searchsorted(input_indptr[1:-1].contiguous().long(), ar, right=True)
    offset = ar - input_indptr.long()[seg_id]
    byte_idx = output_indptr.long()[seg_id] + torch.div(offset, 8, rounding_mode="floor")
    contrib = (x.to(torch.uint8) << (offset % 8).to(torch.uint8)).to(torch.int32)
    byte_idx = torch.where((byte_idx >= 0) & (byte_idx < out_size), byte_idx, out_size)
    out = torch.zeros(out_size + 1, dtype=torch.int32, device=dev)
    out.index_add_(0, byte_idx, contrib)
    return (out[:out_size] & 0xFF).to(torch.uint8)


def build_tree_kernel_efficient(parent_list, selected_index, verified_seq_len, *, depth: int,
                                draft_token_num: int):
    """The EAGLE draft tree's metadata, every row at once.

    parent_list [B, C]: the candidate index of each candidate's parent (-1:
    a child of the root); selected_index [B, dt - 1]: the candidates chosen
    as nodes 1..dt-1, a parent before its children; verified_seq_len [B]:
    the root's position. Returns (tree_mask [B, dt, dt] bool, node j an
    ancestor-or-self of node i; positions [B, dt] int32, root position plus
    depth; retrive_index [B, dt] int32, b * dt + i; retrive_next_token /
    retrive_next_sibling [B, dt] int32, the first child / next sibling, -1
    for none)."""
    b = parent_list.shape[0]
    dt = draft_token_num
    dev = parent_list.device
    pl, sel = parent_list.long(), selected_index.long()
    pc = pl.gather(1, sel)  # parent candidate of each selected node [B, dt-1]
    eq = sel[:, None, :] == pc[:, :, None]  # [B, dt-1, dt-1]
    pnode = torch.where(pc < 0, 0, 1 + eq.to(torch.int32).argmax(-1))
    parent = torch.cat([torch.full((b, 1), -1, dtype=torch.long, device=dev), pnode], dim=1)  # [B, dt]

    nodes = torch.arange(dt, device=dev)
    mask = torch.eye(dt, dtype=torch.bool, device=dev).expand(b, dt, dt).clone()
    node = parent
    for _ in range(depth + 1):  # ancestors up to ``depth`` levels
        mask |= (nodes[None, None, :] == node[:, :, None]) & (node >= 0)[:, :, None]
        node = torch.where(node >= 0, parent.gather(1, node.clamp_min(0)), -1)
    depths = mask.sum(-1) - 1

    child_of = parent[:, None, :] == nodes[None, :, None]  # [B, i, j]: parent[j] == i
    first_child = torch.where(child_of.any(-1), child_of.to(torch.int32).argmax(-1), -1)
    same_parent = (parent[:, None, :] == parent[:, :, None]) & (nodes[None, None, :] > nodes[None, :, None])
    next_sib = torch.where(same_parent.any(-1), same_parent.to(torch.int32).argmax(-1), -1)
    positions = verified_seq_len.long()[:, None] + depths
    retrive_index = torch.arange(b, device=dev)[:, None] * dt + nodes[None, :]
    i32 = torch.int32
    return mask, positions.to(i32), retrive_index.to(i32), first_child.to(i32), next_sib.to(i32)
