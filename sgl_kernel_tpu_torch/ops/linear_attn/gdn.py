"""GDN (Gated DeltaNet) linear attention, Qwen3-Next style
(sgl_kernel_tpu/ops/linear_attn/gdn.py:37-276, plain ``jnp`` there, plain
PyTorch here on either device).

Recurrence (the gated delta rule), S_t [dv, dk] a head:

    g_t    = -exp(A_log) * softplus(a_t + dt_bias)      (log decay)
    beta_t = sigmoid(b_t)
    S_t    = exp(g_t) * S_{t-1}
    o_t    = S_t q_t ;  S_t += beta_t (v_t - S_t k_t) k_t^T

Prefill runs it chunk-parallel (``chunk_gated_delta_rule``, with the
per-step ``gated_delta_rule_scan`` as its oracle), the state frozen past
each sequence's length; decode is the one-step update. The fused q / k / v /
z and b / a projections use the Qwen3-Next grouped layout: qkvz [..., Hk,
2 dk + 2 G dv] = [q | k | v (G heads) | z (G heads)], ba [..., Hk, 2 G] = [b |
a], G = Hv / Hk. q is scaled by dk^-0.5 after its L2 norm, and the k-heads
are repeated to the v-heads. States are [B, Hv, dv, dk] float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..norm import l2norm
from .causal_conv1d import causal_conv1d_fwd, causal_conv1d_update


def unzip_qkvz_ba(qkvz, ba, num_k_heads: int, num_v_heads: int, head_k_dim: int, head_v_dim: int):
    """Split the fused projections. qkvz [..., Hk (2 dk + 2 G dv)]; ba [...,
    Hk 2 G]. Returns q [..., Hk, dk], k [..., Hk, dk], v [..., Hv, dv], z
    [..., Hv, dv], b [..., Hv], a [..., Hv] (views)."""
    g = num_v_heads // num_k_heads
    dk, dv = head_k_dim, head_v_dim
    lead = qkvz.shape[:-1]
    grouped = qkvz.reshape(*lead, num_k_heads, 2 * dk + 2 * g * dv)
    q = grouped[..., :dk]
    k = grouped[..., dk: 2 * dk]
    v = grouped[..., 2 * dk: 2 * dk + g * dv].reshape(*lead, num_v_heads, dv)
    z = grouped[..., 2 * dk + g * dv:].reshape(*lead, num_v_heads, dv)
    ba_g = ba.reshape(*lead, num_k_heads, 2 * g)
    b = ba_g[..., :g].reshape(*lead, num_v_heads)
    a = ba_g[..., g:].reshape(*lead, num_v_heads)
    return q, k, v, z, b, a


def gated_delta_rule_update(q, k, v, g, beta, state):
    """One decode step. q / k [B, H, dk] (L2-normalized), v [B, H, dv], g
    [B, H] log decay, beta [B, H]; state [B, H, dv, dk]. Returns (o [B, H,
    dv] in v's dtype, the new state in state's dtype), in float32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = state.float() * torch.exp(g.float())[..., None, None]
    mem = torch.einsum("bhvk,bhk->bhv", s, kf)
    delta = (vf - mem) * beta.float()[..., None]
    s = s + torch.einsum("bhv,bhk->bhvk", delta, kf)
    o = torch.einsum("bhvk,bhk->bhv", s, qf)
    return o.to(v.dtype), s.to(state.dtype)


def _defaults(q, v, initial_state, seq_lens):
    b, s, h, dk = q.shape
    dev = q.device
    if initial_state is None:
        initial_state = torch.zeros((b, h, v.shape[-1], dk), dtype=torch.float32, device=dev)
    seq_lens = (torch.full((b,), s, dtype=torch.long, device=dev) if seq_lens is None
                else seq_lens.to(dev, torch.long))
    return initial_state, seq_lens


def gated_delta_rule_scan(q, k, v, g, beta, initial_state=None, seq_lens=None):
    """The recurrence one step at a time (the oracle of the chunked form):
    q / k [B, S, H, dk], v [B, S, H, dv], g / beta [B, S, H]. A sequence's
    state freezes past its length and its outputs there are zero. Returns
    (o [B, S, H, dv], final state)."""
    s_len = q.shape[1]
    initial_state, seq_lens = _defaults(q, v, initial_state, seq_lens)
    state = initial_state.float()
    outs = []
    for t in range(s_len):
        o, new = gated_delta_rule_update(q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t], state)
        valid = (t < seq_lens)
        state = torch.where(valid[:, None, None, None], new, state)
        outs.append(torch.where(valid[:, None, None], o.float(), 0.0))
    return torch.stack(outs, dim=1).to(v.dtype), state.to(initial_state.dtype)


def chunk_gated_delta_rule(q, k, v, g, beta, initial_state=None, seq_lens=None, *, chunk: int = 64):
    """The gated delta rule chunk-parallel (the WY representation), as JAX's
    ``chunk_gated_delta_rule``: within a chunk of C steps with inclusive
    local decay G_t = sum_{j<=t} g_j,

        (I + A) U = beta (V - e^G K S_0^T),  A[t,i] = beta_t e^{G_t-G_i} (k_t.k_i) [i<t]
        U  = U0 - W S_0^T,  U0 = Tinv (beta V),  W = Tinv (beta e^G K)
        O  = (e^G Q) S_0^T + M U,   M[t,i] = e^{G_t-G_i} (q_t.k_i) [i<=t]
        S' = e^{G_C} S_0 + sum_t e^{G_C-G_t} u_t k_t^T

    with Tinv = (I + A)^-1 by a triangular solve; only S' runs chunk after
    chunk (a Python loop, JAX's ``lax.scan``). e^{G_t-G_i} overflows above
    the diagonal once decays are large: those entries are discarded by
    ``torch.where``, never multiplied by a 0 / 1 mask (inf x 0 is NaN). g and
    beta are zeroed past each sequence's length, so its state freezes there.

    q / k [B, S, H, dk], v [B, S, H, dv], g / beta [B, S, H]; initial_state
    [B, H, dv, dk]; seq_lens [B]. Returns (o [B, S, H, dv] in v's dtype, zero
    past the lengths; the final state in initial_state's dtype)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    initial_state, seq_lens = _defaults(q, v, initial_state, seq_lens)
    c = min(chunk, s)
    pad = (-s) % c
    n = (s + pad) // c

    def prep(x):
        x = x.float()
        if pad:
            x = torch.cat([x, x.new_zeros((b, pad) + tuple(x.shape[2:]))], dim=1)
        # [B, S', H, ...] -> [B, H, N, C, ...]
        x = x.movedim(2, 1)
        return x.reshape(b, h, n, c, *x.shape[3:])

    valid = (torch.arange(s + pad, device=dev)[None, :] < seq_lens[:, None])[:, :, None]  # [B, S', 1]
    valid_s = valid[:, :s]
    gm = prep(torch.where(valid_s, g.float(), 0.0))
    bm = prep(torch.where(valid_s, beta.float(), 0.0))
    qc, kc, vc = prep(q), prep(k), prep(v)

    G = torch.cumsum(gm, dim=-1)                          # [B, H, N, C] inclusive
    eG = torch.exp(G)
    tri_s = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev), diagonal=-1)  # strict lower
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))                  # inclusive
    rel = torch.exp(G[..., :, None] - G[..., None, :])    # e^{G_t - G_i}
    kk = torch.einsum("bhntd,bhnid->bhnti", kc, kc)
    A = torch.where(tri_s, bm[..., :, None] * rel * kk, 0.0)
    eye = torch.eye(c, dtype=torch.float32, device=dev)
    Tinv = torch.linalg.solve_triangular(eye + A, eye.expand(A.shape), upper=False)
    U0 = torch.einsum("bhnti,bhniv->bhntv", Tinv, bm[..., None] * vc)
    W = torch.einsum("bhnti,bhnid->bhntd", Tinv, (bm * eG)[..., None] * kc)
    qk = torch.einsum("bhntd,bhnid->bhnti", qc, kc)
    M = torch.where(tri, rel * qk, 0.0)
    eGq = eG[..., None] * qc                               # [B, H, N, C, dk]
    carry_decay = torch.exp(G[..., -1])                    # e^{G_C} [B, H, N]
    tail_decay = torch.exp(G[..., -1:] - G)                # e^{G_C - G_t} [B, H, N, C]

    S = initial_state.float()
    outs = []
    for i in range(n):
        u = U0[:, :, i] - torch.einsum("bhtd,bhvd->bhtv", W[:, :, i], S)                    # [B, H, C, dv]
        o = torch.einsum("bhtd,bhvd->bhtv", eGq[:, :, i], S) + torch.einsum("bhti,bhiv->bhtv", M[:, :, i], u)
        S = (carry_decay[:, :, i][..., None, None] * S
             + torch.einsum("bhtv,bhtd->bhvd", tail_decay[:, :, i][..., None] * u, kc[:, :, i]))
        outs.append(o)
    o = torch.stack(outs, dim=2).reshape(b, h, n * c, dv)[:, :, :s].movedim(1, 2)  # [B, S, H, dv]
    o = torch.where(valid[:, :s, :, None], o, 0.0)
    return o.to(v.dtype), S.to(initial_state.dtype)


def _decay_terms(a, b, a_log, dt_bias):
    """g = -exp(A_log) softplus(a + dt_bias) and beta = sigmoid(b), float32."""
    g = -torch.exp(a_log.float()) * F.softplus(a.float() + dt_bias.float())
    beta = torch.sigmoid(b.float())
    return g, beta


def _qk(conv_out, lead, num_k_heads: int, num_v_heads: int, head_k_dim: int, head_v_dim: int):
    """q / k / v out of the conv's [q | k | v] features: q and k
    L2-normalized (q then scaled by dk^-0.5) and repeated to the v-heads."""
    nk = num_k_heads * head_k_dim
    q = l2norm(conv_out[..., :nk].reshape(*lead, num_k_heads, head_k_dim)) * (head_k_dim ** -0.5)
    k = l2norm(conv_out[..., nk: 2 * nk].reshape(*lead, num_k_heads, head_k_dim))
    v = conv_out[..., 2 * nk:].reshape(*lead, num_v_heads, head_v_dim)
    g_rep = num_v_heads // num_k_heads
    return q.repeat_interleave(g_rep, dim=-2), k.repeat_interleave(g_rep, dim=-2), v


def gdn_attention_prefill(qkvz, ba, conv_weight, conv_bias, a_log, dt_bias, conv_state, ssm_state, seq_lens, *,
                          num_k_heads: int, num_v_heads: int, head_k_dim: int, head_v_dim: int,
                          activation: str = "silu"):
    """A GDN layer's prefill: unzip -> causal conv over the [q | k | v]
    features (carrying ``conv_state``) -> L2 norm of q / k -> the chunked
    gated delta rule (carrying ``ssm_state``). qkvz [B, S, Hk (2 dk + 2 G
    dv)]; ba [B, S, Hk 2 G]; conv_weight [conv_dim, W], conv_dim = 2 Hk dk +
    Hv dv. Returns (core_out [B, S, Hv, dv], z [B, S, Hv, dv], conv_state,
    ssm_state)."""
    bsz, s, _ = qkvz.shape
    q, k, v, z, b, a = unzip_qkvz_ba(qkvz, ba, num_k_heads, num_v_heads, head_k_dim, head_v_dim)
    mixed = torch.cat([q.reshape(bsz, s, -1), k.reshape(bsz, s, -1), v.reshape(bsz, s, -1)], dim=-1)
    conv_out, conv_state = causal_conv1d_fwd(mixed, conv_weight, conv_bias, seq_lens, conv_state,
                                             activation=activation)
    q, k, v = _qk(conv_out, (bsz, s), num_k_heads, num_v_heads, head_k_dim, head_v_dim)
    g, beta = _decay_terms(a, b, a_log, dt_bias)
    o, ssm_state = chunk_gated_delta_rule(q, k, v, g, beta, ssm_state, seq_lens)
    return o, z, conv_state, ssm_state


def gdn_attention_decode(qkvz, ba, conv_weight, conv_bias, a_log, dt_bias, conv_state, ssm_state, *,
                         num_k_heads: int, num_v_heads: int, head_k_dim: int, head_v_dim: int,
                         activation: str = "silu"):
    """One token of a GDN layer: qkvz [B, Hk (2 dk + 2 G dv)], ba [B, Hk 2
    G]. Returns (o [B, Hv, dv], z [B, Hv, dv], conv_state, ssm_state)."""
    bsz = qkvz.shape[0]
    q, k, v, z, b, a = unzip_qkvz_ba(qkvz, ba, num_k_heads, num_v_heads, head_k_dim, head_v_dim)
    mixed = torch.cat([q.reshape(bsz, -1), k.reshape(bsz, -1), v.reshape(bsz, -1)], dim=-1)
    conv_out, conv_state = causal_conv1d_update(mixed, conv_state, conv_weight, conv_bias, activation=activation)
    q, k, v = _qk(conv_out, (bsz,), num_k_heads, num_v_heads, head_k_dim, head_v_dim)
    g, beta = _decay_terms(a, b, a_log, dt_bias)
    o, ssm_state = gated_delta_rule_update(q, k, v, g, beta, ssm_state)
    return o, z, conv_state, ssm_state
