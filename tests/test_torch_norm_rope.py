"""Parity of the port's norm and RoPE operators (K2 rmsnorm, K3
rope_decode_fused_qkv, K4 rope_decode_fused and their plain neighbours)
with the JAX package.

The same numpy-seeded bytes go through the JAX function (its Pallas kernels
in interpret mode on the CPU) and the port's CPU path (the kernels' plain
PyTorch twins)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import norm as jnorm
from sgl_kernel_tpu.ops import rope as jrope
from sgl_kernel_tpu_torch.interop import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import norm as tnorm
from sgl_kernel_tpu_torch.ops import rope as trope

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# float32: both sides compute the same float32 chain, only the reduction
# order differs. bf16: one output rounding to 8 mantissa bits (2^-8 = 0.4%)
# may land on the other side of a tie, so allow one bf16 ulp.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}


def both(x, jdt):
    """numpy float32 -> (jax array of jdt, torch tensor of the same bytes)."""
    xj = jnp.asarray(x, jdt)
    return xj, tensor_from_numpy(np.asarray(xj), "cpu")


def close(a_jax, b_torch, **tol):
    np.testing.assert_allclose(np.asarray(a_jax, np.float32), b_torch.float().numpy(), **tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 128), (3, 4, 256), (7, 96)])
@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm(rng, dt, shape, gemma):
    jdt, _ = DTYPES[dt]
    xj, xt = both(rng.standard_normal(shape).astype(np.float32) * 3, jdt)
    wj, wt = both(rng.standard_normal(shape[-1]).astype(np.float32), jdt)
    ref = jnorm.rmsnorm(xj, wj, 1e-5, gemma=gemma)
    out = tnorm.rmsnorm(xt, wt, 1e-5, gemma=gemma)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    close(ref, out, **TOL[dt])


def test_fused_add_rmsnorm(rng):
    x = rng.standard_normal((6, 128)).astype(np.float32)
    r = rng.standard_normal((6, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    oj, rj = jnorm.fused_add_rmsnorm(jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), 1e-6)
    ot, rt = tnorm.fused_add_rmsnorm(torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(w), 1e-6)
    close(oj, ot, **TOL["f32"])
    close(rj, rt, **TOL["f32"])


@pytest.mark.parametrize("kw", [
    {},
    dict(scaling_factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0, original_max_position=64),
    dict(scaling_factor=2.0),
])
def test_cos_sin_cache(kw):
    # float32 transcendental functions of two libraries: a few ulp apart
    ref = jrope.compute_cos_sin_cache(64, 128, 500000.0, **kw)
    out = trope.compute_cos_sin_cache(64, 128, 500000.0, device="cpu", **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (128, 64)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rot", [32, 16])
def test_rotary_embedding(rng, dt, rot):
    jdt, _ = DTYPES[dt]
    t, hq, hk, d = 9, 4, 2, 32
    cache = jrope.compute_cos_sin_cache(rot, 64, 10000.0)
    cache_t = torch.from_numpy(np.asarray(cache))
    pos = rng.integers(0, 64, t).astype(np.int32)
    qj, qt = both(rng.standard_normal((t, hq * d)).astype(np.float32), jdt)
    kj, kt = both(rng.standard_normal((t, hk, d)).astype(np.float32), jdt)
    rq, rk = jrope.rotary_embedding(jnp.asarray(pos), qj, kj, d, cache)
    oq, ok = trope.rotary_embedding(torch.from_numpy(pos), qt, kt, d, cache_t)
    assert oq.shape == qt.shape and ok.shape == kt.shape
    close(rq, oq, **TOL[dt])
    close(rk, ok, **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("nq,nkv,d,rot", [(4, 2, 32, 32), (8, 2, 64, 32), (32, 8, 128, 128)])
def test_rope_decode_fused_qkv(rng, dt, nq, nkv, d, rot):
    jdt, _ = DTYPES[dt]
    b = 5
    cache = jrope.compute_cos_sin_cache(rot, 256, 500000.0)
    cache_t = torch.from_numpy(np.asarray(cache))
    pos = rng.integers(0, 256, b).astype(np.int32)
    xj, xt = both(rng.standard_normal((b, (nq + 2 * nkv) * d)).astype(np.float32), jdt)
    ref = jrope.rope_decode_fused_qkv(jnp.asarray(pos), xj, cache, num_q=nq, num_kv=nkv, head_dim=d)
    out = trope.rope_decode_fused_qkv(torch.from_numpy(pos), xt, cache_t, num_q=nq, num_kv=nkv, head_dim=d)
    for r, o, h in zip(ref, out, (nq, nkv, nkv)):
        assert tuple(o.shape) == (b, h, d) and o.dtype == xt.dtype
        close(r, o, **TOL[dt])
    # v is a copy, bit for bit
    np.testing.assert_array_equal(np.asarray(ref[2], np.float32), out[2].float().numpy())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d,rot", [(4, 2, 32, 32), (8, 2, 64, 32), (32, 8, 128, 128), (4, 4, 96, 64)])
def test_rope_decode_fused(rng, dt, hq, hkv, d, rot):
    """K4's twin against the Pallas kernel (interpret mode): q and k split,
    rot < D passing the tail through."""
    jdt, _ = DTYPES[dt]
    b = 5
    cache = jrope.compute_cos_sin_cache(rot, 256, 1e6)
    cache_t = torch.from_numpy(np.asarray(cache))
    pos = rng.integers(0, 256, b).astype(np.int32)
    qj, qt = both(rng.standard_normal((b, hq, d)).astype(np.float32), jdt)
    kj, kt = both(rng.standard_normal((b, hkv, d)).astype(np.float32), jdt)
    ref = jrope.rope_decode_fused(jnp.asarray(pos), qj, kj, cache)
    out = trope.rope_decode_fused(torch.from_numpy(pos), qt, kt, cache_t)
    for r, o, x in zip(ref, out, (qt, kt)):
        assert o.shape == x.shape and o.dtype == x.dtype
        close(r, o, **TOL[dt])
        # the dims past rot pass through, bit for bit
        np.testing.assert_array_equal(np.asarray(r, np.float32)[..., rot:], o[..., rot:].float().numpy())
    assert trope.rope_decode_fused.launches == 0  # a CPU tensor takes the twin


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("nq,nk,nv,d,rot", [(4, 2, 2, 32, 32), (8, 2, 2, 64, 32), (32, 8, 8, 128, 128)])
def test_fused_qk_norm_rope(rng, dt, nq, nk, nv, d, rot):
    """Qwen3's per-head q / k RMSNorm then RoPE over packed qkv [T, (Hq +
    Hk + Hv) D]; v passes through unchanged."""
    jdt, _ = DTYPES[dt]
    t = 9
    qj, qt = both(rng.standard_normal((t, (nq + nk + nv) * d)).astype(np.float32), jdt)
    wq, wqt = both((1 + 0.2 * rng.standard_normal(d)).astype(np.float32), jdt)
    wk, wkt = both((1 + 0.2 * rng.standard_normal(d)).astype(np.float32), jdt)
    pos = rng.integers(0, 64, t).astype(np.int32)
    jc = jrope.compute_cos_sin_cache(rot, 64, 10000.0)
    tc = trope.compute_cos_sin_cache(rot, 64, 10000.0, device="cpu")
    ref = jrope.fused_qk_norm_rope(qj, nq, nk, nv, d, wq, wk, jnp.asarray(pos), jc)
    out = trope.fused_qk_norm_rope(qt, nq, nk, nv, d, wqt, wkt, torch.from_numpy(pos), tc)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    close(ref, out, **TOL[dt])
    assert torch.equal(out[:, (nq + nk) * d:], qt[:, (nq + nk) * d:])


def test_rope_decode_rejects_bad_width():
    with pytest.raises(ValueError):
        trope.rope_decode_fused_qkv(torch.zeros(2, dtype=torch.int32), torch.zeros(2, 100),
                                    torch.zeros(8, 32), num_q=4, num_kv=2, head_dim=32)
    with pytest.raises(ValueError):
        trope.rope_decode_fused(torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4, 32), torch.zeros(2, 2, 32),
                                torch.zeros(8, 48))
