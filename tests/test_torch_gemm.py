"""Parity of the port's W4A16 GEMM module with the JAX package: the seven
layout functions byte for byte, and K1's plain twin against the Pallas
kernel (interpret mode) for every option of the contract. Inputs are made
with numpy from a seed and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.gemm import w4a16 as jw
from sgl_kernel_tpu.ops.quant import formats as jformats
from sgl_kernel_tpu_torch.interop import tensor_from_numpy
from sgl_kernel_tpu_torch.ops.gemm import w4a16 as tw
from sgl_kernel_tpu_torch.ops.quant import formats as tformats

torch.set_num_threads(1)


def t(x):
    """A JAX array (or numpy array) -> the same bytes as a CPU tensor."""
    return tensor_from_numpy(np.asarray(x), "cpu")


def same_bytes(a_jax, b_torch):
    """Byte-identical: same shape, same dtype width, same bits."""
    a = np.asarray(a_jax)
    b = b_torch.contiguous()
    assert tuple(a.shape) == tuple(b.shape), (a.shape, b.shape)
    assert a.dtype.itemsize == b.element_size(), (a.dtype, b.dtype)
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[b.element_size()]
    np.testing.assert_array_equal(a.view(np.dtype(f"u{a.dtype.itemsize}")),
                                  b.view(view).numpy().view(np.dtype(f"u{a.dtype.itemsize}")))


# ---------------------------------------------------------------------------
# Layouts: byte-identical to JAX
# ---------------------------------------------------------------------------


def test_nibble_formats(rng):
    codes = rng.integers(0, 16, (6, 40)).astype(np.uint8)
    same_bytes(jformats.pack_int4(jnp.asarray(codes)), tformats.pack_int4(torch.from_numpy(codes)))
    packed = rng.integers(0, 256, (6, 20)).astype(np.uint8)
    same_bytes(jformats.unpack_int4(jnp.asarray(packed)), tformats.unpack_int4(torch.from_numpy(packed)))
    words = rng.integers(-2 ** 31, 2 ** 31, (5, 4)).astype(np.int32)
    same_bytes(jformats.awq_unpack_int32(jnp.asarray(words)), tformats.awq_unpack_int32(torch.from_numpy(words)))
    assert tuple(tformats.AWQ_ORDER) == tuple(jformats.AWQ_ORDER.tolist())


def test_pack_unpack_w4(rng):
    codes = rng.integers(0, 16, (64, 24)).astype(np.uint8)
    pj = jw.pack_w4_tpu(jnp.asarray(codes))
    pt = tw.pack_w4_tpu(torch.from_numpy(codes))
    same_bytes(pj, pt)
    same_bytes(jw.unpack_w4_tpu(pj), tw.unpack_w4_tpu(pt))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("nkg", [(64, 256, 128), (48, 200, 32), (32, 96, 64)])
def test_quantize_w4_bytes(rng, symmetric, nkg):
    """Scales rounded to bf16 before the codes are fitted, round half to
    even: the same bytes; K=200 and K=96 are zero-padded to 8 groups."""
    n, k, g = nkg
    wf = (rng.standard_normal((n, k)) * 0.05 + 0.01).astype(np.float32)
    wf[0, :g] = 0.0  # an all-zero group: the 1e-10 scale floor
    wf[1, :8] = 7 * 2.0 ** -8  # codes at exact .5 ties after the bf16 scale
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        wj = jnp.asarray(wf, jdt)
        out_j = jw.quantize_w4(wj, group_size=g, symmetric=symmetric)
        out_t = tw.quantize_w4(t(wj), group_size=g, symmetric=symmetric)
        for a, b in zip(out_j, out_t):
            if a is None:
                assert b is None
            else:
                same_bytes(a, b)


@pytest.mark.parametrize("fmt,zeros", [("int4", False), ("int4", True), ("mxfp4", False)])
def test_dequant_w4_bytes(rng, fmt, zeros):
    k, n, g = 128, 40, 32
    packed = rng.integers(0, 256, (k // 2, n)).astype(np.uint8)
    scales = jnp.asarray(rng.random((k // g, n)) + 0.1, jnp.bfloat16)
    z = jnp.asarray(rng.standard_normal((k // g, n)) * 0.1, jnp.bfloat16) if zeros else None
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        ref = jw.dequant_w4(jnp.asarray(packed), scales, z, group_size=g, fmt=fmt, dtype=jdt)
        out = tw.dequant_w4(torch.from_numpy(packed), t(scales), t(z) if zeros else None, group_size=g,
                            fmt=fmt, dtype=tdt)
        same_bytes(ref, out)


def test_awq_to_tpu_layout_bytes(rng):
    k, n, g = 256, 64, 128
    qweight = rng.integers(-2 ** 31, 2 ** 31, (k, n // 8)).astype(np.int32)
    qzeros = rng.integers(-2 ** 31, 2 ** 31, (k // g, n // 8)).astype(np.int32)
    scales = (rng.random((k // g, n)) * 0.02).astype(np.float32)
    ref = jw.awq_to_tpu_layout(jnp.asarray(qweight), jnp.asarray(scales), jnp.asarray(qzeros), group_size=g)
    out = tw.awq_to_tpu_layout(torch.from_numpy(qweight), torch.from_numpy(scales), torch.from_numpy(qzeros),
                               group_size=g)
    for a, b in zip(ref, out):
        same_bytes(a, b)


@pytest.mark.parametrize("desc_act", [False, True])
def test_gptq_to_tpu_layout_bytes(rng, desc_act):
    k, n, g = 256, 64, 64
    qweight = rng.integers(-2 ** 31, 2 ** 31, (k // 8, n)).astype(np.int32)
    qzeros = rng.integers(-2 ** 31, 2 ** 31, (k // g, n // 8)).astype(np.int32)
    scales = (rng.random((k // g, n)) * 0.02).astype(np.float32)
    g_idx = rng.permutation(np.arange(k) // g).astype(np.int32) if desc_act else None
    ref = jw.gptq_to_tpu_layout(jnp.asarray(qweight), jnp.asarray(qzeros), jnp.asarray(scales),
                                None if g_idx is None else jnp.asarray(g_idx), group_size=g)
    out = tw.gptq_to_tpu_layout(torch.from_numpy(qweight), torch.from_numpy(qzeros), torch.from_numpy(scales),
                                None if g_idx is None else torch.from_numpy(g_idx), group_size=g)
    for a, b in zip(ref[:3], out[:3]):
        same_bytes(a, b)
    if desc_act:
        same_bytes(ref[3], out[3])
    else:
        assert ref[3] is None and out[3] is None


def test_mxfp4_to_tpu_layout_bytes(rng):
    n, k = 48, 128
    q = rng.integers(0, 256, (n, k // 2)).astype(np.uint8)
    sb = rng.integers(100, 150, (n, k // 32)).astype(np.uint8)
    ref = jw.mxfp4_to_tpu_layout(jnp.asarray(q), jnp.asarray(sb))
    out = tw.mxfp4_to_tpu_layout(torch.from_numpy(q), torch.from_numpy(sb))
    for a, b in zip(ref, out):
        same_bytes(a, b)


# ---------------------------------------------------------------------------
# K1's plain twin against the Pallas kernel
# ---------------------------------------------------------------------------

# Both sides round the prologue to bf16 at the same point and scale each
# group's f32 partial product per column; what differs is the order of the
# f32 sums inside a group (~1e-7 relative) and, rarely, a bf16 rounding of
# one prologue element that the two frameworks' sigmoid or rsqrt put on
# either side of a tie (2^-8 of one term of a K-long sum).
TOL = dict(rtol=1e-4, atol=1e-4)

OPTIONS = ["int4", "mxfp4", "zeros", "bias", "a2_silu", "fused_gate_up", "residual", "norm",
           "norm_stacked", "layer_id", "padded_k", "bf16_out"]


def k1_case(rng, option, m):
    """(args, kwargs) of one call, as numpy-backed JAX arrays."""
    n, k, g = 256, 256, 64
    lay = 3
    bf = jnp.bfloat16
    a = jnp.asarray(rng.standard_normal((m, k)), bf)
    kw = dict(group_size=g, out_dtype=jnp.float32)
    stacked = option in ("layer_id", "norm_stacked", "fused_gate_up")
    if option == "mxfp4":
        kw.update(fmt="mxfp4", group_size=32)
        w = jnp.asarray(rng.integers(0, 256, (k // 2, n)), jnp.uint8)
        s = jnp.asarray(np.exp2(rng.integers(-6, -2, (k // 32, n))), bf)
        return (a, w, s), kw
    kk = 200 if option == "padded_k" else k
    wf = rng.standard_normal((lay if stacked else 1, n, kk)) * 0.05 + (0.02 if option == "zeros" else 0.0)
    qs = [jw.quantize_w4(jnp.asarray(x, jnp.float32), group_size=g, symmetric=option != "zeros") for x in wf]
    w, s, z = (jnp.stack(p) if stacked else p[0] for p in zip(*[(q[0], q[1], q[2] if q[2] is not None else q[1])
                                                                for q in qs]))
    if option == "zeros":
        kw["zeros"] = z
    elif option == "bias":
        kw["bias"] = jnp.asarray(rng.standard_normal(n), jnp.float32)
    elif option == "a2_silu":
        kw.update(a2=jnp.asarray(rng.standard_normal((m, k)), bf), prologue="silu_mul")
    elif option == "fused_gate_up":
        a = jnp.asarray(rng.standard_normal((m, 2 * k)), bf)
        kw.update(prologue="silu_mul", fused_gate_up=True, layer_id=1,
                  residual=jnp.asarray(rng.standard_normal((m, n)), bf))
    elif option == "residual":
        kw["residual"] = jnp.asarray(rng.standard_normal((m, n)), bf)
    elif option == "norm":
        a = jnp.asarray(rng.standard_normal((m, k)) * 3, bf)
        kw.update(norm_weight=jnp.asarray(rng.standard_normal(k), bf), norm_eps=1e-5)
    elif option == "norm_stacked":
        kw.update(norm_weight=jnp.asarray(rng.standard_normal((lay, k)), bf), layer_id=2, norm_eps=1e-6)
    elif option == "layer_id":
        kw["layer_id"] = 2
    elif option == "padded_k":
        a = jnp.asarray(rng.standard_normal((m, kk)), bf)
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


@pytest.mark.parametrize("m", [3, 16, 40, 72])
@pytest.mark.parametrize("option", OPTIONS)
def test_w4a16_twin_matches_pallas(rng, option, m):
    args, kw = k1_case(rng, option, m)
    ref = np.asarray(jw.w4a16_gemm(*args, **kw), np.float32)
    targs, tkw = [t(x) for x in args], to_torch_kwargs(kw)
    out = tw.w4a16_gemm(*targs, **tkw)
    assert out.dtype == tkw["out_dtype"] and tuple(out.shape) == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    if option == "bf16_out":
        # one cast of the same f32 value; order-of-sum noise may cross a
        # rounding boundary: at most one bf16 ulp (2^-8 relative)
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8, atol=2 ** -8 * scale)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    # the twin is what a CPU tensor runs: the same function
    np.testing.assert_array_equal(out.float().numpy(), tw.w4a16_gemm_ref(*targs, **tkw).float().numpy())


def test_w4a16_contract_only_tiles(rng):
    """bm / bn / bk / gmode chose the TPU kernel's tiles and schedule: the
    JAX results under other tiles are the twin's."""
    args, kw = k1_case(rng, "zeros", 16)
    out = tw.w4a16_gemm(*[t(x) for x in args], **to_torch_kwargs(kw), bm=8, bn=128, bk=128, gmode="batched")
    for tiles in (dict(bm=8, bn=128, bk=128, gmode="batched"), dict(gmode="inner2")):
        ref = np.asarray(jw.w4a16_gemm(*args, **kw, **tiles), np.float32)
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(ref).max())


def test_w4a16_contract_errors(rng):
    (a, w, s), _ = k1_case(rng, "int4", 4)
    a, w, s = t(a), t(w), t(s)
    bad = [dict(fmt="nf4"), dict(prologue="silu_mul"), dict(a2=a),
           dict(fused_gate_up=True), dict(norm_weight=torch.ones(256), prologue="silu_mul", a2=a),
           dict(zeros=s[:1]), dict(residual=torch.zeros(4, 3))]
    for kw in bad:
        with pytest.raises(ValueError):
            tw.w4a16_gemm(a, w, s, group_size=64, **kw)
    with pytest.raises(ValueError):  # activations wider than the packed K
        tw.w4a16_gemm(torch.zeros(4, 300, dtype=a.dtype), w, s, group_size=64)


@pytest.mark.parametrize("m,n,k,expect", [
    (16, 6144, 4096, (0, 264, 3)),      # qkv decode: 48 column tiles x 16 k blocks over 264 blocks
    (16, 4096, 14336, (0, 264, 7)),     # down decode: 32 x 56 stages
    (32, 28672, 4096, (1, 264, 14)),    # gate_up decode, 32 rows: 224 x 16 stages
    (16, 129024, 4096, (0, 264, 62)),   # lm_head: 1008 x 16 stages
    (1024, 28672, 4096, (2, 1, 32)),    # prefill tile
])
def test_w4a16_launch_plan(m, n, k, expect):
    """Decode: two blocks an SM take equal shares of the (128-column tile,
    256-deep k block) stages, which they cover once. Prefill on the
    mma.sync tile (weights the wgmma tile cannot take): K splits in whole groups,
    covering every group once. On mappable weights decode rows take the
    decode kernel and prefill rows the wgmma tile."""
    tile, split, per = tw.plan(m, n, k, 128, n_sm=132)
    assert (tile, split, per) == expect
    assert tw.route(m, k, True) == ("decode" if m <= 32 else "wgmma")
    if tile == 2:
        assert (split - 1) * per < k // 128 <= split * per
    else:
        stages = -(-n // 128) * (k // 256)
        assert split * (per - 1) < stages <= split * per


@pytest.mark.parametrize("m", [1, 16, 17, 32])
@pytest.mark.parametrize("n", [16, 1000 * 16, 6144, 28672, 129024])
@pytest.mark.parametrize("k,g", [(256, 32), (1152, 128), (4096, 64), (14336, 128), (96, 32)])
def test_w4a16_decode_plan_covers_k(m, n, k, g):
    """Every decode plan: the blocks' equal shares of the (tile, k block)
    stages cover each stage once (a K short of a k block still takes one),
    at most one block a stage and two an SM, no share more than one stage
    above another."""
    tile, blocks, per = tw.plan(m, n, k, g, n_sm=132)
    assert tile == (0 if m <= 16 else 1)
    stages = -(-n // 128) * -(-k // 256)
    assert blocks == min(264, stages)
    shares = [stages * (b + 1) // blocks - stages * b // blocks for b in range(blocks)]
    assert sum(shares) == stages and min(shares) >= 1 and max(shares) == per <= min(shares) + 1


@pytest.mark.parametrize("m,n,k,vec_w,expect", [
    (16, 6144, 4096, True, "decode"),       # a decode step's qkv
    (32, 28672, 4096, True, "decode"),
    (16, 200, 4096, False, "tile"),         # ragged N: TMA cannot map the weight rows
    (33, 6144, 4096, True, "wgmma"),        # the smallest prefill
    (1040, 6144, 4096, True, "wgmma"),      # a mixed step
    (16384, 28672, 4096, True, "wgmma"),    # wave A's packed gate_up
    (1024, 200, 4096, False, "tile"),       # ragged N
    (1024, 256, 1376, True, "tile"),        # K of 43 groups of 32: not whole 128-deep stages
])
def test_w4a16_route(m, n, k, vec_w, expect):
    """Which kernel a call takes: the decode kernel at M <= 32, the wgmma
    tile above it, the mma.sync tile where TMA cannot map the weights or K is not
    whole 128-deep stages."""
    assert tw.route(m, k, vec_w) == expect


@pytest.mark.parametrize("m,n,k,expect", [
    (1024, 28672, 4096, (128, 1, 32)),   # gate_up: 8 x 224 tiles of 128 x 128 fill the SMs
    (1024, 4096, 14336, (128, 1, 112)),  # down: 256 tiles
    (16384, 28672, 4096, (128, 1, 32)),  # wave A's gate_up
    (1040, 6144, 4096, (128, 1, 32)),    # a mixed step's qkv: 432 tiles
    (33, 6144, 4096, (64, 5, 7)),        # 24 tiles of 64 x 256: K in 5 splits of 7 stages (the last 4), 120 blocks
    (200, 4096, 4096, (128, 2, 16)),     # 64 tiles: two splits, 128 blocks
    (64, 256, 8192, (64, 16, 4)),        # one tile: splits of 4 stages, the fewest a split takes
    (64, 256, 256, (64, 1, 2)),          # 2 stages: too few to split
])
def test_w4a16_wgmma_plan(m, n, k, expect):
    """The wgmma tile's launch: 64-row blocks of 256 columns up to 64 rows,
    128-row blocks of 128 columns above; K splits in whole 128-deep stages
    (at least 4 a split) only where the tiles cannot give every SM a block,
    never into a second wave; the splits cover every stage once, none
    empty."""
    bm, split, per = tw.wgmma_plan(m, n, k, n_sm=132)
    assert (bm, split, per) == expect
    stages = k // 128
    assert (split - 1) * per < stages <= split * per
    assert split == 1 or (per >= 4 and -(-m // bm) * -(-n // (128 * (128 // bm))) * split <= 132)
