"""ops/linear_attn and norm.l2norm in the port against the JAX package: the
causal conv1d (varlen prefill with a carried state, the decode update), the
gated delta rule (the one-step update, the per-step scan, the chunked form),
the GDN layer ops, the state-pool functions and the lightning decode.

Inputs are seeded with numpy and fed to both sides as the same bytes.
Tolerances: float32 on both sides, summed in other orders (einsum paths, a
triangular solve where JAX's is another algorithm): outputs and states
within 1e-5 of their scale for the elementwise ops and the one-step
recurrences, 1e-4 for the chunked form and the layer ops (a chunk's solve
and its inter-chunk products), bf16 l2norm within one bf16 ulp (2^-8) of
its scale; the state-pool functions move rows and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import linear_attn as jla
from sgl_kernel_tpu.ops import norm as jnorm
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import linear_attn as tla
from sgl_kernel_tpu_torch.ops import norm as tnorm

torch.set_num_threads(1)

OP_TOL = 1e-5
CHUNK_TOL = 1e-4


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2norm(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(randn(rng, 3, 5, 16, scale=3.0), dtype)
    got = tnorm.l2norm(t(x))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    close(got, jnorm.l2norm(x), OP_TOL if dtype == "float32" else 2.0 ** -8)


def test_causal_conv1d_fwd_varlen_state_carry_and_update():
    """Ragged lengths (one empty) from a carried state: y, zero past each
    length, and the final state (the last W-1 valid inputs, reaching back
    into the initial state for a short sequence); a second chunk carries it.
    The decode update, step by step from the same state, gives fwd's rows."""
    rng = np.random.default_rng(1)
    b, s, d, w = 3, 9, 12, 4
    x, wt, bias = randn(rng, b, s, d), randn(rng, d, w, scale=0.3), randn(rng, d, scale=0.1)
    init = randn(rng, b, w - 1, d)
    lens = np.array([9, 2, 0], np.int32)
    y_j, st_j = jla.causal_conv1d_fwd(x, wt, bias, lens, init)
    y_t, st_t = tla.causal_conv1d_fwd(t(x), t(wt), t(bias), t(lens), t(init))
    close(y_t, y_j, OP_TOL)
    close(st_t, st_j, OP_TOL)
    assert not y_t[1, 2:].any() and not y_t[2].any()
    assert torch.equal(st_t[2], t(init)[2]) and torch.equal(st_t[1, :1], t(init)[1, 2:])
    x2 = randn(rng, b, 5, d)
    y2_j, st2_j = jla.causal_conv1d_fwd(x2, wt, None, None, st_j, activation=None)
    y2_t, st2_t = tla.causal_conv1d_fwd(t(x2), t(wt), None, None, st_t, activation=None)
    close(y2_t, y2_j, OP_TOL)
    close(st2_t, st2_j, OP_TOL)
    state = t(init)
    for i in range(s):
        yi_t, state_new = tla.causal_conv1d_update(t(x[:, i]), state, t(wt), t(bias))
        yi_j, _ = jla.causal_conv1d_update(x[:, i], np.asarray(state), wt, bias)
        close(yi_t, yi_j, OP_TOL)
        close(yi_t[0], y_t[0, i], OP_TOL)
        state = state_new
    close(state[0], st_t[0], OP_TOL)


def _rule_inputs(rng, b, s, h, dk, dv, decay=1.0):
    q = randn(rng, b, s, h, dk)
    k = randn(rng, b, s, h, dk)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = randn(rng, b, s, h, dv)
    g = (-decay * np.abs(randn(rng, b, s, h))).astype(np.float32)
    beta = (1 / (1 + np.exp(-randn(rng, b, s, h)))).astype(np.float32)
    s0 = randn(rng, b, h, dv, dk, scale=0.5)
    return q, k, v, g, beta, s0


def test_gated_delta_rule_update_and_scan():
    rng = np.random.default_rng(2)
    q, k, v, g, beta, s0 = _rule_inputs(rng, 2, 6, 3, 8, 5)
    o_j, s_j = jla.gated_delta_rule_update(q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0], s0)
    o_t, s_t = tla.gated_delta_rule_update(*(t(a[:, 0]) for a in (q, k, v, g, beta)), t(s0))
    close(o_t, o_j, OP_TOL)
    close(s_t, s_j, OP_TOL)
    lens = np.array([6, 3], np.int32)
    o_j, s_j = jla.gated_delta_rule_scan(q, k, v, g, beta, s0, lens)
    o_t, s_t = tla.gated_delta_rule_scan(*map(t, (q, k, v, g, beta, s0, lens)))
    close(o_t, o_j, OP_TOL)
    close(s_t, s_j, OP_TOL)
    assert not o_t[1, 3:].any()


@pytest.mark.parametrize("s,chunk,decay", [(7, 4, 1.0), (16, 8, 1.0), (20, 64, 0.3), (12, 8, 30.0)])
def test_chunk_gated_delta_rule(s, chunk, decay):
    """The chunked form against JAX's and against the port's per-step scan,
    over ragged lengths (the state freezes past them, the outputs are zero).
    Decay 30 a step makes e^{G_t - G_i} overflow to inf above the diagonal
    within a chunk: those entries must be discarded, not multiplied out."""
    rng = np.random.default_rng(3)
    q, k, v, g, beta, s0 = _rule_inputs(rng, 2, s, 2, 8, 6, decay)
    lens = np.array([s, max(1, s - 5)], np.int32)
    o_j, s_j = jla.chunk_gated_delta_rule(q, k, v, g, beta, s0, lens, chunk=chunk)
    args = [t(a) for a in (q, k, v, g, beta, s0, lens)]
    o_t, s_t = tla.chunk_gated_delta_rule(*args, chunk=chunk)
    close(o_t, o_j, CHUNK_TOL)
    close(s_t, s_j, CHUNK_TOL)
    o_s, s_s = tla.gated_delta_rule_scan(*args)
    close(o_t, o_s.numpy(), CHUNK_TOL)
    close(s_t, s_s.numpy(), CHUNK_TOL)
    assert not o_t[1, lens[1]:].any()
    if decay > 20:  # the chunk's relative decays do overflow: the where() is exercised
        G = np.cumsum(g[0, :chunk, 0].astype(np.float64))
        assert (G[0] - G[-1]) > 88.7


def test_gdn_attention_prefill_then_decode():
    """A GDN layer's prefill over two ragged prompts from carried states,
    then two decode steps from the states it left: outputs, z and both
    states against JAX's."""
    rng = np.random.default_rng(4)
    hk, hv, dk, dv, w = 2, 4, 8, 6, 4
    g = hv // hk
    qkvz_dim, ba_dim, conv_dim = hk * (2 * dk + 2 * g * dv), hk * 2 * g, 2 * hk * dk + hv * dv
    kw = dict(num_k_heads=hk, num_v_heads=hv, head_k_dim=dk, head_v_dim=dv)
    b, s = 2, 11
    qkvz, ba = randn(rng, b, s, qkvz_dim), randn(rng, b, s, ba_dim)
    conv_w, conv_b = randn(rng, conv_dim, w, scale=0.3), randn(rng, conv_dim, scale=0.1)
    a_log, dt_bias = randn(rng, hv, scale=0.1), randn(rng, hv, scale=0.1)
    conv0, ssm0 = randn(rng, b, w - 1, conv_dim), randn(rng, b, hv, dv, dk, scale=0.3)
    lens = np.array([11, 6], np.int32)
    wts = (conv_w, conv_b, a_log, dt_bias)
    out_j = jla.gdn_attention_prefill(qkvz, ba, *wts, conv0, ssm0, lens, **kw)
    out_t = tla.gdn_attention_prefill(t(qkvz), t(ba), *map(t, wts), t(conv0), t(ssm0), t(lens), **kw)
    for got, want in zip(out_t, out_j):
        close(got, want, CHUNK_TOL)
    cs_j, ss_j, cs_t, ss_t = out_j[2], out_j[3], out_t[2], out_t[3]
    for step in range(2):
        x1, x2 = randn(rng, b, qkvz_dim), randn(rng, b, ba_dim)
        dec_j = jla.gdn_attention_decode(x1, x2, *wts, cs_j, ss_j, **kw)
        dec_t = tla.gdn_attention_decode(t(x1), t(x2), *map(t, wts), cs_t, ss_t, **kw)
        for got, want in zip(dec_t, dec_j):
            close(got, want, CHUNK_TOL)
        cs_j, ss_j, cs_t, ss_t = dec_j[2], dec_j[3], dec_t[2], dec_t[3]
    q, k, v, z, bb, aa = tla.unzip_qkvz_ba(t(qkvz), t(ba), hk, hv, dk, dv)
    ref = jla.unzip_qkvz_ba(qkvz, ba, hk, hv, dk, dv)
    for got, want in zip((q, k, v, z, bb, aa), ref):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_state_cache_functions():
    """update / gather / gather_scatter on a float32 SSM-like pool and a
    bf16 conv-like pool with negative and past-the-pool slots: equal to
    JAX's results, updated in place."""
    rng = np.random.default_rng(5)
    for dtype in ("float32", "bfloat16"):
        cache = jnp.asarray(randn(rng, 6, 3, 4), dtype)
        new = jnp.asarray(randn(rng, 4, 3, 4), dtype)
        idx = np.array([2, -1, 5, 7], np.int32)
        pool = t(cache)
        got = tla.state_cache_update(pool, t(idx), t(new))
        assert got is pool
        assert np.array_equal(got.float().numpy(), np.asarray(jla.state_cache_update(cache, idx, new), np.float32))
        gidx = np.array([4, -2, 0, 4], np.int32)
        assert np.array_equal(tla.state_cache_gather(t(cache), t(gidx)).float().numpy(),
                              np.asarray(jla.state_cache_gather(cache, gidx), np.float32))
        src, dst = np.array([0, -1, 3, 1], np.int32), np.array([3, 2, -1, 0], np.int32)
        pool = t(cache)
        got = tla.state_cache_gather_scatter(pool, t(src), t(dst))
        assert got is pool
        assert np.array_equal(got.float().numpy(),
                              np.asarray(jla.state_cache_gather_scatter(cache, src, dst), np.float32))


def test_lightning_attention_decode():
    rng = np.random.default_rng(6)
    b, h, dk, dv = 2, 3, 8, 5
    q, k, v = randn(rng, b, h, 1, dk), randn(rng, b, h, 1, dk), randn(rng, b, h, 1, dv)
    past, slope = randn(rng, b, h, dk, dv), np.abs(randn(rng, h, 1, 1))
    o_j, kv_j = jla.lightning_attention_decode(q, k, v, past, slope)
    o_t, kv_t = tla.lightning_attention_decode(*map(t, (q, k, v, past, slope)))
    close(o_t, o_j, OP_TOL)
    close(kv_t, kv_j, OP_TOL)


def test_linear_attn_exports_match_jax():
    """The port's package exports every function JAX's does, by name."""
    import sgl_kernel_tpu.ops.linear_attn as j

    names = {n for n in dir(j) if not n.startswith("_") and callable(getattr(j, n))}
    assert len(names) == 12
    assert all(callable(getattr(tla, n, None)) for n in names), names - set(dir(tla))
