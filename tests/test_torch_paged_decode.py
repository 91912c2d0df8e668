"""Parity of the port's head-major paged decode (K8, ``paged_attention_decode``)
with the JAX package: the same numpy-seeded bytes through the Pallas kernel
in interpret mode and through the port's plain twin on the CPU, over pools
[Hkv, P, page, D] and layer-stacked [L, Hkv, P, page, D], with every option
of the contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.attention import paged_decode as jk8
from sgl_kernel_tpu_torch.interop import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import attention as tatt
from sgl_kernel_tpu_torch.ops.attention import paged_decode as tk8

torch.set_num_threads(1)

# float32 inputs: the Pallas kernel runs an online softmax over pages, the
# twin one dense softmax; the sums differ in order, a few float32 ulp.
F32 = dict(rtol=2e-5, atol=2e-5)
# bf16 q / pools: the Pallas kernel rounds q * k_scale and the probabilities
# to bf16 before its products (2^-8 relative); the twin keeps the
# probabilities in float32.
BF16 = dict(rtol=2e-2, atol=2e-2)


def both(x, jdt):
    xj = jnp.asarray(x, jdt)
    return xj, tensor_from_numpy(np.asarray(xj), "cpu")


def close(a_jax, b_torch, **tol):
    np.testing.assert_allclose(np.asarray(a_jax, np.float32), b_torch.float().numpy(), **tol)


def head_case(rng, b, hq, hkv, d, page, lengths, n_layers=2, jdt=jnp.float32, pool_dt=None):
    """Head-major pools (stacked when ``n_layers``) with each sequence's
    pages scattered; q and fresh rows in ``jdt``; fp8 pools from codes that
    avoid denormals and NaN (the JAX upcast differs there by design)."""
    n_blocks = max(1, -(-max(lengths) // page)) + 1
    n_pages = b * n_blocks + 1
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_blocks), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // page)
        table[i, :used] = perm[i * n_blocks: i * n_blocks + used]
    shape = (hkv, n_pages, page, d) if n_layers is None else (n_layers, hkv, n_pages, page, d)
    if pool_dt is None:
        pools = [both(rng.standard_normal(shape).astype(np.float32), jdt) for _ in range(2)]
    else:
        pools = []
        for _ in range(2):
            codes = rng.integers(0, 256, shape).astype(np.uint8)
            e = (codes >> 3) & 0xF
            codes = np.where((e == 0) | (e == 15), codes ^ 0x40, codes).astype(np.uint8)
            xj = jnp.asarray(codes).view(jnp.float8_e4m3fn)
            pools.append((xj, tensor_from_numpy(np.asarray(xj), "cpu")))
    rest = [both(rng.standard_normal(s).astype(np.float32), jdt) for s in ((b, hq, d), (b, hkv, d), (b, hkv, d))]
    return table, pools + rest


@pytest.mark.parametrize("pps", [1, 4])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 4), (8, 2)])
@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_k8_twin_matches_pallas(rng, jdt, hq, hkv, pps):
    """GQA groups 1, 2, 4; stacked pools with layer_id; fresh K/V; both
    pages_per_step (a TPU grid-step size: the same function)."""
    b, d, page = 4, 32, 16
    lengths = [1, 37, 5, 2 * page + 5]
    table, [(kj, kt), (vj, vt), (qj, qt), (fkj, fkt), (fvj, fvt)] = head_case(rng, b, hq, hkv, d, page, lengths,
                                                                              jdt=jdt)
    lens = np.array(lengths, np.int32)
    for layer in (0, 1):
        ref = jk8.paged_attention_decode(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), layer_id=layer,
                                         fresh_k=fkj, fresh_v=fvj, pages_per_step=pps)
        out = tk8.paged_attention_decode(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table), layer_id=layer,
                                         fresh_k=fkt, fresh_v=fvt, pages_per_step=pps)
        assert out.shape == qt.shape and out.dtype == qt.dtype
        close(ref, out, **(F32 if jdt == jnp.float32 else BF16))


@pytest.mark.parametrize("pps", [1, 4])
def test_k8_options_lse(rng, pps):
    """Sinks, sliding window, soft cap and the base-2 lse, unstacked pools,
    no fresh row."""
    b, hq, hkv, d, page = 3, 8, 2, 32, 16
    lengths = [70, 9, 33]
    table, [(kj, kt), (vj, vt), (qj, qt), _, _] = head_case(rng, b, hq, hkv, d, page, lengths, n_layers=None)
    lens = np.array(lengths, np.int32)
    sinks = rng.standard_normal(hq).astype(np.float32)
    kw = dict(sliding_window=20, logit_soft_cap=4.0, return_lse=True, pages_per_step=pps)
    ro, rl = jk8.paged_attention_decode(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), jnp.asarray(sinks), **kw)
    oo, ol = tk8.paged_attention_decode(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table),
                                        torch.from_numpy(sinks), **kw)
    close(ro, oo, **F32)
    close(rl, ol, **F32)


@pytest.mark.parametrize("fresh", [True, False])
def test_k8_fp8_pools_scales(rng, fresh):
    """fp8 e4m3 pools with per-tensor k/v scales: q * k_scale and fresh rows
    / scale rounded to q's dtype, the output scaled again
    (paged_decode.py:229-238, :302-303); bf16 q."""
    b, hq, hkv, d, page = 3, 8, 2, 32, 16
    lengths = [40, 3, 17]
    table, [(kj, kt), (vj, vt), (qj, qt), (fkj, fkt), (fvj, fvt)] = head_case(
        rng, b, hq, hkv, d, page, lengths, jdt=jnp.bfloat16, pool_dt="e4m3")
    lens = np.array(lengths, np.int32)
    fj = dict(fresh_k=fkj, fresh_v=fvj) if fresh else {}
    ft = dict(fresh_k=fkt, fresh_v=fvt) if fresh else {}
    kw = dict(k_scale=0.5, v_scale=0.25, layer_id=1)
    ref = jk8.paged_attention_decode(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), **fj, **kw)
    out = tk8.paged_attention_decode(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table), **ft, **kw)
    close(ref, out, **BF16)


def test_k8_is_k5_over_the_head_layout(rng):
    """K8 and K5 with layout="head" are one function on the same pools, and
    K5 over the page-major transpose gives it too."""
    b, hq, hkv, d, page = 3, 8, 2, 32, 16
    lengths = [30, 1, 17]
    table, [(_, kt), (_, vt), (_, qt), (_, fkt), (_, fvt)] = head_case(rng, b, hq, hkv, d, page, lengths)
    args = (torch.tensor(lengths, dtype=torch.int32), torch.from_numpy(table))
    kw = dict(layer_id=1, fresh_k=fkt, fresh_v=fvt, return_lse=True)
    o8, l8 = tatt.paged_attention_decode(qt, kt, vt, *args, **kw)
    o5, l5 = tatt.paged_attention_decode_dma(qt, kt, vt, *args, layout="head", **kw)
    op, lp = tatt.paged_attention_decode_dma(qt, kt.transpose(1, 2).contiguous(), vt.transpose(1, 2).contiguous(),
                                             *args, **kw)
    for o, lse in ((o5, l5), (op, lp)):
        assert torch.equal(o, o8) and torch.equal(lse, l8)
