"""Parity of the port's KV-cache stores (K6 store_cache_all_layers and the
per-layer store_cache_stacked) with the JAX package. A store is a copy, so
the pools must agree bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import kvcache as jkv
from sgl_kernel_tpu_torch.interop import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import kvcache as tkv

torch.set_num_threads(1)


def pools(rng, l, p, h, page, d, jdt):
    kp = jnp.asarray(rng.standard_normal((l, p, h, page, d)).astype(np.float32), jdt)
    vp = jnp.asarray(rng.standard_normal((l, p, h, page, d)).astype(np.float32), jdt)
    return kp, vp, tensor_from_numpy(np.asarray(kp), "cpu"), tensor_from_numpy(np.asarray(vp), "cpu")


def same(a_jax, b_torch):
    np.testing.assert_array_equal(np.asarray(a_jax, np.float32), b_torch.float().numpy())


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_store_cache_all_layers(rng, page, jdt):
    l, p, h, d = 3, 4, 2, 32
    kp, vp, kpt, vpt = pools(rng, l, p, h, page, d, jdt)
    # valid slots, a dropped -1, an out-of-range slot (= P*page), the last slot
    loc = np.array([5, -1, p * page, 2 * page + 3, p * page - 1, page + 7], np.int32)
    t = loc.shape[0]
    ka = jnp.asarray(rng.standard_normal((l, t, h, d)).astype(np.float32), jdt)
    va = jnp.asarray(rng.standard_normal((l, t, h, d)).astype(np.float32), jdt)
    rk, rv = jkv.store_cache_all_layers(ka, va, kp, vp, jnp.asarray(loc))
    ok, ov = tkv.store_cache_all_layers(tensor_from_numpy(np.asarray(ka), "cpu"),
                                        tensor_from_numpy(np.asarray(va), "cpu"), kpt, vpt,
                                        torch.from_numpy(loc))
    assert ok is kpt and ov is vpt  # in place
    same(rk, ok)
    same(rv, ov)


def test_store_cache_all_layers_token_order(rng):
    """Two tokens on one slot: the later token wins, as in the JAX kernel."""
    l, p, h, page, d = 2, 3, 2, 16, 32
    kp, vp, kpt, vpt = pools(rng, l, p, h, page, d, jnp.float32)
    loc = np.array([9, 20, 9], np.int32)
    ka = jnp.asarray(rng.standard_normal((l, 3, h, d)).astype(np.float32))
    va = jnp.asarray(rng.standard_normal((l, 3, h, d)).astype(np.float32))
    rk, rv = jkv.store_cache_all_layers(ka, va, kp, vp, jnp.asarray(loc))
    ok, ov = tkv.store_cache_all_layers(tensor_from_numpy(ka, "cpu"), tensor_from_numpy(va, "cpu"),
                                        kpt, vpt, torch.from_numpy(loc))
    same(rk, ok)
    same(rv, ov)
    np.testing.assert_array_equal(ok[:, 0, :, 9].numpy(), np.asarray(ka)[:, 2])


@pytest.mark.parametrize("page", [16, 64])
def test_store_cache_stacked(rng, page):
    l, p, h, d = 3, 4, 2, 32
    kp, vp, kpt, vpt = pools(rng, l, p, h, page, d, jnp.bfloat16)
    loc = np.array([0, 1, -1, -1, 3 * page + 2, p * page + 5], np.int32)
    k = jnp.asarray(rng.standard_normal((6, h, d)).astype(np.float32), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((6, h, d)).astype(np.float32), jnp.bfloat16)
    rk, rv = jkv.store_cache_stacked(k, v, kp, vp, jnp.asarray(loc), 1)
    ok, ov = tkv.store_cache_stacked(tensor_from_numpy(np.asarray(k), "cpu"),
                                     tensor_from_numpy(np.asarray(v), "cpu"), kpt, vpt,
                                     torch.from_numpy(loc), 1)
    same(rk, ok)
    same(rv, ov)


@pytest.mark.parametrize("kind", ["int8", "float8_e4m3fn", "float8_e5m2"])
def test_stores_on_one_byte_pools(rng, kind):
    """int8 / fp8 pools (rows of D bytes) take the model's already
    quantized K/V (llama._kv_quant): both stores copy the codes bit for
    bit, as the JAX ones do."""
    l, p, h, page, d = 2, 3, 2, 16, 32
    jdt = getattr(jnp, kind)

    def codes(shape):
        if kind == "int8":
            return jnp.asarray(rng.integers(-127, 128, shape).astype(np.int8))
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)

    kp, vp = codes((l, p, h, page, d)), codes((l, p, h, page, d))
    kpt, vpt = tensor_from_numpy(np.asarray(kp), "cpu"), tensor_from_numpy(np.asarray(vp), "cpu")
    assert kpt.dtype == getattr(torch, kind)
    loc = np.array([5, -1, p * page, 2 * page + 3, 5], np.int32)
    ka, va = codes((l, 5, h, d)), codes((l, 5, h, d))
    rk, rv = jkv.store_cache_all_layers(ka, va, kp, vp, jnp.asarray(loc))
    tkv.store_cache_all_layers(tensor_from_numpy(np.asarray(ka), "cpu"), tensor_from_numpy(np.asarray(va), "cpu"),
                               kpt, vpt, torch.from_numpy(loc))
    k1, v1 = codes((5, h, d)), codes((5, h, d))
    rk, rv = jkv.store_cache_stacked(k1, v1, rk, rv, jnp.asarray(loc[::-1].copy()), 1)
    tkv.store_cache_stacked(tensor_from_numpy(np.asarray(k1), "cpu"), tensor_from_numpy(np.asarray(v1), "cpu"),
                            kpt, vpt, torch.from_numpy(loc[::-1].copy()), 1)
    for a, b in ((rk, kpt), (rv, vpt)):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), b.view(torch.uint8).numpy())


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_store_cache_head_major(rng, jdt):
    """The head-major store of K8's pools [H, P, page, D]: valid slots, a
    dropped -1 and an out-of-range slot, bit for bit against JAX's scatter;
    a layer of stacked pools updates in place."""
    h, p, page, d = 2, 4, 16, 32
    kp = jnp.asarray(rng.standard_normal((h, p, page, d)).astype(np.float32), jdt)
    vp = jnp.asarray(rng.standard_normal((h, p, page, d)).astype(np.float32), jdt)
    loc = np.array([5, -1, p * page, 2 * page + 3, p * page - 1], np.int32)
    k = jnp.asarray(rng.standard_normal((5, h, d)).astype(np.float32), jdt)
    v = jnp.asarray(rng.standard_normal((5, h, d)).astype(np.float32), jdt)
    rk, rv = jkv.store_cache_head_major(k, v, kp, vp, jnp.asarray(loc))
    stacked_k = torch.stack([tensor_from_numpy(np.asarray(kp), "cpu")] * 2)
    stacked_v = torch.stack([tensor_from_numpy(np.asarray(vp), "cpu")] * 2)
    ok, ov = tkv.store_cache_head_major(tensor_from_numpy(np.asarray(k), "cpu"), tensor_from_numpy(np.asarray(v), "cpu"),
                                        stacked_k[1], stacked_v[1], torch.from_numpy(loc))
    assert ok.data_ptr() == stacked_k[1].data_ptr()  # in place
    same(rk, stacked_k[1])
    same(rv, stacked_v[1])
    same(kp, stacked_k[0])  # the other layer untouched
    # nothing kept: the pools do not change
    tkv.store_cache_head_major(tensor_from_numpy(np.asarray(k), "cpu")[:2], tensor_from_numpy(np.asarray(v), "cpu")[:2],
                               stacked_k[0], stacked_v[0], torch.tensor([-1, p * page], dtype=torch.int32))
    same(kp, stacked_k[0])


def _drop_scatter_by_unique(flat, rows, vals):
    """The host-syncing store this module had before (a boolean index and
    torch.unique), kept as the oracle of its replacement."""
    rows = rows.reshape(-1)
    vals = vals.reshape(rows.shape[0], -1).to(flat.dtype)
    keep = (rows >= 0) & (rows < flat.shape[0])
    rows, vals = rows[keep], vals[keep]
    if rows.numel():
        uniq, inv = torch.unique(rows, return_inverse=True)
        last = torch.full((uniq.shape[0],), -1, dtype=torch.long, device=rows.device)
        last.scatter_reduce_(0, inv, torch.arange(rows.shape[0], device=rows.device), "amax")
        flat[uniq] = vals[last]
    return flat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn])
def test_drop_scatter_without_host_sync_keeps_last_wins(dtype):
    """store_cache_stacked's drop (a stable sort of the rows and a neighbour
    compare, no boolean index) writes what the old unique-based store wrote,
    bit for bit: rows written several times keep their last value, rows
    below 0 or past the pool are dropped, including calls where every row is
    dropped or one row is written by all."""
    gen = torch.Generator().manual_seed(3)
    n_rows, d = 40, 8
    cases = [torch.randint(-3, n_rows + 3, (64,), generator=gen),   # duplicates, negatives, past the pool
             torch.full((5,), -1), torch.full((6,), 7), torch.tensor([n_rows, -2, 0, 0])]
    for rows in cases:
        vals = (torch.randn((rows.shape[0], d), generator=gen) * 8).to(dtype)
        base = (torch.randn((n_rows, d), generator=gen) * 8).to(dtype)
        want = _drop_scatter_by_unique(base.clone(), rows, vals)
        got = tkv._drop_scatter(base.clone(), rows, vals)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), rows
