"""Parity of the port's decode-bucket W4A16 GEMM (K10, ``w4a16_gemm_dma``)
with the JAX package: the same numpy-seeded bytes through the Pallas kernel
in interpret mode and through the port's plain twin on the CPU, for every
option of the contract, plus the launch plan of the card's kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.gemm import w4a16 as jw
from sgl_kernel_tpu.ops.gemm import w4a16_dma as jdma
from sgl_kernel_tpu_torch.interop import tensor_from_numpy
from sgl_kernel_tpu_torch.ops.gemm import w4a16_dma as tdma
from sgl_kernel_tpu_torch.ops.gemm import w4a16_stream

torch.set_num_threads(1)

# float32 outputs of the same codes and scales: the Pallas kernel and the
# twin take each group's partial product in float32 and scale it per
# column; only the summation order differs (a few float32 ulp of the
# output's scale).
TOL = dict(rtol=1e-4, atol=1e-4)

OPTIONS = ["int4", "zeros", "bias", "silu_mul", "residual", "layer_id", "mxfp4", "bf16_out"]


def t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def k10_case(rng, option, m, g):
    """(args, kwargs) of one JAX call: K=256, N=256, bf16 activations."""
    n, k, lay = 256, 256, 3
    bf = jnp.bfloat16
    a = jnp.asarray(rng.standard_normal((m, k)), bf)
    kw = dict(group_size=g, out_dtype=jnp.float32)
    if option == "mxfp4":
        kw.update(fmt="mxfp4", group_size=32)
        w = jnp.asarray(rng.integers(0, 256, (k // 2, n)), jnp.uint8)
        s = jnp.asarray(np.exp2(rng.integers(-6, -2, (k // 32, n))), bf)
        return (a, w, s), kw
    stacked = option == "layer_id"
    wf = rng.standard_normal((lay if stacked else 1, n, k)) * 0.05 + (0.02 if option == "zeros" else 0.0)
    qs = [jw.quantize_w4(jnp.asarray(x, jnp.float32), group_size=g, symmetric=option != "zeros") for x in wf]
    w, s, z = (jnp.stack(p) if stacked else p[0] for p in zip(*[(q[0], q[1], q[2] if q[2] is not None else q[1])
                                                                for q in qs]))
    if option == "zeros":
        kw["zeros"] = z
    elif option == "bias":
        kw["bias"] = jnp.asarray(rng.standard_normal(n), jnp.float32)
    elif option == "silu_mul":
        kw.update(a2=jnp.asarray(rng.standard_normal((m, k)), bf), prologue="silu_mul",
                  residual=jnp.asarray(rng.standard_normal((m, n)), bf))
    elif option == "residual":
        kw["residual"] = jnp.asarray(rng.standard_normal((m, n)), bf)
    elif option == "layer_id":
        kw["layer_id"] = 2
    elif option == "bf16_out":
        kw["out_dtype"] = bf
    return (a, w, s), kw


def to_torch_kwargs(kw):
    out = {}
    for key, v in kw.items():
        if key == "out_dtype":
            out[key] = torch.float32 if v == jnp.float32 else torch.bfloat16
        elif isinstance(v, jnp.ndarray):
            out[key] = t(v)
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("m", [1, 8, 16, 32])
@pytest.mark.parametrize("option", OPTIONS)
def test_w4a16_gemm_dma_twin_matches_pallas(rng, option, m, g):
    args, kw = k10_case(rng, option, m, g)
    ref = np.asarray(jdma.w4a16_gemm_dma(*args, **kw), np.float32)
    targs, tkw = [t(x) for x in args], to_torch_kwargs(kw)
    out = tdma.w4a16_gemm_dma(*targs, **tkw)
    assert out.dtype == tkw["out_dtype"] and tuple(out.shape) == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    if option == "bf16_out":
        # one cast of the same f32 value; order-of-sum noise may cross a
        # rounding boundary: at most one bf16 ulp (2^-8 relative)
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8, atol=2 ** -8 * scale)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    # the twin is what a CPU tensor runs: the same function
    np.testing.assert_array_equal(out.float().numpy(), tdma.w4a16_gemm_dma_ref(*targs, **tkw).float().numpy())


def test_w4a16_gemm_dma_contract_only_args(rng):
    """bn / bk / nbuf / unroll / gmode chose the TPU kernel's tile, chunk,
    buffers and schedule: the JAX results under other values are the twin's."""
    args, kw = k10_case(rng, "zeros", 16, 32)
    out = tdma.w4a16_gemm_dma(*[t(x) for x in args], **to_torch_kwargs(kw), bn=128, bk=128, nbuf=3)
    for extra in (dict(bn=128, bk=128, nbuf=3), dict(gmode="loop", unroll=False)):
        ref = np.asarray(jdma.w4a16_gemm_dma(*args, **kw, **extra), np.float32)
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(ref).max())


def test_w4a16_gemm_dma_contract_errors(rng):
    (a, w, s), _ = k10_case(rng, "int4", 4, 64)
    a, w, s = t(a), t(w), t(s)
    bad = [dict(fmt="nf4"), dict(prologue="silu_mul"), dict(a2=a), dict(zeros=s[:1]),
           dict(residual=torch.zeros(4, 3))]
    for kw in bad:
        with pytest.raises(ValueError):
            tdma.w4a16_gemm_dma(a, w, s, group_size=64, **kw)
    with pytest.raises(ValueError):  # the decode bucket only
        tdma.w4a16_gemm_dma(torch.zeros(33, 256, dtype=a.dtype), w, s, group_size=64)
    with pytest.raises(ValueError):  # no zero-padded K: activations match the packed K
        tdma.w4a16_gemm_dma(torch.zeros(4, 200, dtype=a.dtype), w, s, group_size=64)
    with pytest.raises(TypeError):  # no norm prologue, no fused gate/up
        tdma.w4a16_gemm_dma(a, w, s, group_size=64, norm_weight=torch.ones(256))


@pytest.mark.parametrize("m,n,k,g,zeros,expect", [
    (16, 6144, 4096, 128, False, (132, 24, 16)),     # qkv: 384 units over 132 blocks
    (16, 4096, 4096, 128, False, (132, 16, 16)),     # o: 256 units
    (16, 28672, 4096, 128, False, (132, 112, 16)),   # gate_up: 1,792 units
    (16, 4096, 14336, 128, False, (132, 16, 56)),    # down: 896 units, a tile shared by ~8 blocks
    (32, 28672, 4096, 128, False, (132, 112, 16)),   # 32 rows: the same units, twice the rows a unit
    (16, 4096, 4096, 32, True, (132, 16, 16)),       # group 32 with zeros: eight scale groups a unit
])
def test_w4a16_gemm_dma_launch_plan(m, n, k, g, zeros, expect):
    """The grid comes from the SM count alone (one block an SM); the units
    are (256-column tile, 256-deep k block); every unit is taken by one
    block, in the kernel's order: whole tiles where that is within half a
    tile of stream-K's longest share (gate_up: 112 tiles of 16 k blocks on
    132 blocks), else an equal share (+-1) in tile-major order, so a tile is
    shared by at most the blocks whose shares meet in it."""
    blocks, tiles, n_kb = tdma.plan(m, n, k, n_sm=132)
    assert (blocks, tiles, n_kb) == expect
    shares = w4a16_stream.work_units(1, tiles, n_kb, blocks)
    units = [u for share in shares for u in share]
    assert sorted(units) == [(t, kb) for t in range(tiles) for kb in range(n_kb)]
    sizes = [len(share) for share in shares]
    assert max(sizes) <= -(-tiles * n_kb // blocks) + n_kb // 2
    assert all(share == sorted(share) for share in shares)


@pytest.mark.parametrize("n_rb,tiles,n_kb", [(1, 1, 1), (1, 3, 5), (1, 112, 32), (1, 504, 32), (1, 16, 112)])
@pytest.mark.parametrize("blocks", [1, 7, 264])
@pytest.mark.parametrize("order", [w4a16_stream.ORDER_TILE, w4a16_stream.ORDER_KSYNC, w4a16_stream.ORDER_AUTO])
def test_w4a16_stream_unit_share(n_rb, tiles, n_kb, blocks, order):
    """The core's division of the work (``Share`` in csrc/w4a16_stream.cuh):
    every (tile, k block) taken exactly once whatever the grid; a block's
    rounds are whole tiles b, b + blocks, ..; the rest is one contiguous
    tile-major run a block. Tile-major and k-sync shares are equal within
    one unit; the automatic order is either tile-major's or all whole
    tiles, then no block longer than tile-major's longest by more than
    half a tile's units."""
    shares = w4a16_stream.work_units(n_rb, tiles, n_kb, blocks, order)
    assert len(shares) == blocks
    units = [u for share in shares for u in share]
    assert sorted(units) == [(t, kb) for t in range(n_rb * tiles) for kb in range(n_kb)]
    sizes = [len(share) for share in shares]
    tile_major = w4a16_stream.work_units(n_rb, tiles, n_kb, blocks, w4a16_stream.ORDER_TILE)
    whole = order == w4a16_stream.ORDER_AUTO and shares != tile_major
    if whole:
        assert max(sizes) <= max(len(s) for s in tile_major) + n_kb // 2
    else:
        assert max(sizes) - min(sizes) <= 1
    tt = n_rb * tiles
    rounds = tt // blocks if order == w4a16_stream.ORDER_KSYNC or whole else 0
    for b, share in enumerate(shares):
        n_whole = rounds + (1 if whole and b < tt % blocks else 0)
        head, tail = share[: n_whole * n_kb], share[n_whole * n_kb:]
        assert head == [(r * blocks + b, kb) for r in range(n_whole) for kb in range(n_kb)]
        assert not (whole and tail)
        flat = [t * n_kb + kb for t, kb in tail]
        assert flat == list(range(flat[0], flat[0] + len(flat))) if flat else True
