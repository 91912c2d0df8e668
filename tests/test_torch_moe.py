"""The port's MoE stack against the JAX package's on the same inputs (numpy,
from a seed): biased and softmax top-k routing, the block alignment, K11's
plain twin (``w4a16_grouped_mm`` on CPU tensors) against the Pallas kernel
in interpret mode, K12's twin (stacked and unstacked) against its Pallas
kernel, ``ragged_grouped_mm`` against ``jax.lax.ragged_dot``, and
``fused_experts`` on stacked int4 and bf16 banks and on unstacked bf16 banks
(the grouped branch at up to 64 tokens, ragged_dot's above).

Tolerances: routing ids and every alignment array are exact (integers; the
weights are the same float32 ops). The grouped GEMMs and fused_experts take
float32 products of identical operands in another summation order: 2e-5 of
the output's scale for float32 outputs; bf16 outputs one bf16 ulp (2^-8 of
the scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import moe as jmoe
from sgl_kernel_tpu.ops.gemm import w4a16 as jw4
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import activation
from sgl_kernel_tpu_torch.ops import moe as tmoe
from sgl_kernel_tpu_torch.ops.gemm import w4a16_stream

torch.set_num_threads(1)


def t_(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(out, ref, rel):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    assert np.abs(out - ref).max() <= tol, (float(np.abs(out - ref).max()), tol)


@pytest.mark.parametrize("shared,renorm,rsf", [(0, True, 2.5), (1, True, 1.0), (0, False, 2.5), (2, False, 1.0)])
def test_biased_topk(shared, renorm, rsf):
    rng = np.random.default_rng(1)
    t, e, k = 37, 16, 6
    g = rng.standard_normal((t, e)).astype(np.float32)
    g[:5] = np.round(g[:5])  # equal scores: the lower expert id first, as jax.lax.top_k
    bias = (rng.standard_normal(e) * 0.1).astype(np.float32)
    bias[:8] = 0.0
    kw = dict(renormalize=renorm, routed_scaling_factor=rsf, apply_routed_scaling_factor_on_output=True,
              num_fused_shared_experts=shared)
    jw, jids = jmoe.biased_topk(jnp.asarray(g), jnp.asarray(bias), k, **kw)
    tw, tids = tmoe.biased_topk(t_(g), t_(bias), k, **kw)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t,k,e,bs", [(16, 4, 8, 8), (1, 6, 64, 16), (16, 6, 64, 16), (300, 6, 64, 128), (5, 2, 4, 32)])
def test_alignment_arrays(t, k, e, bs):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, e, (t, k)).astype(np.int32)
    if t > 10:
        ids[: t // 2] = 3  # a skewed expert
    w = rng.random((t, k)).astype(np.float32)
    ja = jmoe.moe_align_block_size(jnp.asarray(ids), jnp.asarray(w), e, bs)
    ta = tmoe.moe_align_block_size(t_(ids), t_(w), e, bs)
    for name in ja._fields:
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)), err_msg=name)
    assert ta.num_valid_blocks.ndim == 0 and ta.num_valid_blocks.dtype == torch.int32
    # the port's extra field, the combine's gather map: the inverse of sorted_pair_ids
    assert torch.equal(ta.sorted_pair_ids[ta.pair_slots.long()], torch.arange(t * k, dtype=torch.int32))
    assert tmoe.pick_block_size(t, k, e) == jmoe.pick_block_size(t, k, e)
    h = rng.standard_normal((t, 24)).astype(np.float32)
    xs = tmoe.scatter_tokens_to_experts(t_(h), ta)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jmoe.scatter_tokens_to_experts(jnp.asarray(h), ja)))
    y = rng.standard_normal((xs.shape[0], 24)).astype(np.float32)
    np.testing.assert_allclose(tmoe.apply_shuffle_mul_sum(t_(y), ta, t).numpy(),
                               np.asarray(jmoe.apply_shuffle_mul_sum(jnp.asarray(y), ja, t)), rtol=1e-5, atol=1e-6)


def grouped_case(rng, *, e=4, k=256, n=128, gs=64, fmt="int4", zeros=False, layers=None, bm=16, blocks=5,
                 valid=4):
    """Inputs of one grouped call: bf16 x [blocks*bm, k], packed codes,
    bf16 scales (and zeros), block expert ids, the valid block count."""
    lead = (layers, e) if layers else (e,)
    w = rng.integers(0, 256, lead + (k // 2, n)).astype(np.uint8)
    if fmt == "mxfp4":
        s = np.exp2(rng.integers(-8, -3, lead + (k // gs, n))).astype(np.float32)
    else:
        s = (rng.random(lead + (k // gs, n)) * 0.02 + 0.005).astype(np.float32)
    z = (rng.standard_normal(lead + (k // gs, n)) * 0.01).astype(np.float32) if zeros else None
    x = rng.standard_normal((blocks * bm, k)).astype(np.float32)
    eids = rng.integers(0, e, blocks).astype(np.int32)
    eids[valid:] = eids[valid - 1] if valid else 0  # trailing blocks pinned, as the alignment does
    bf = lambda a: None if a is None else np.asarray(jnp.asarray(a, jnp.bfloat16))
    return bf(x), w, bf(s), bf(z), eids, np.int32(valid)


@pytest.mark.parametrize("fmt,zeros,layers,gs,bm,valid", [
    ("int4", False, None, 64, 16, 4),
    ("int4", True, None, 32, 32, 3),
    ("mxfp4", False, None, 32, 16, 5),
    ("int4", False, 3, 128, 16, 2),
    ("int4", True, 2, 64, 64, 1),
    ("mxfp4", True, 2, 32, 128, 3),
    ("int4", False, None, 128, 128, 5),
])
def test_w4a16_grouped_mm_twin(fmt, zeros, layers, gs, bm, valid):
    """K11's twin against the Pallas kernel (interpret mode) on the rows of
    valid blocks: int4, zeros, mxfp4, stacked banks under layer_id, and a
    valid block count below the block count."""
    rng = np.random.default_rng(3)
    x, w, s, z, eids, nv = grouped_case(rng, fmt=fmt, zeros=zeros, layers=layers, gs=gs, bm=bm)
    lid = layers - 1 if layers else None
    kw = dict(group_size=gs, fmt=fmt, bm=bm, out_dtype=jnp.float32)
    ref = jmoe.w4a16_grouped_mm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(eids),
                                None if z is None else jnp.asarray(z), lid, jnp.asarray(nv), **kw)
    kw["out_dtype"] = torch.float32
    out = tmoe.w4a16_grouped_mm(t_(x), t_(w), t_(s), t_(eids), None if z is None else t_(z), lid,
                                torch.tensor(nv), **kw)
    rows = int(nv) * bm
    close(out[:rows], np.asarray(ref)[:rows], 2e-5)
    assert tmoe.w4a16_grouped_mm.launches == 0  # a CPU tensor takes the twin


def test_w4a16_grouped_mm_padded_k_and_per_channel():
    """An activation K below the packed (group-padded) K, and per-channel
    [E, 1, N] scales applied to every group."""
    rng = np.random.default_rng(4)
    x, w, s, _, eids, nv = grouped_case(rng, k=256, gs=128, valid=5)
    xk = x[:, :200]
    ref = jmoe.w4a16_grouped_mm(jnp.asarray(xk), jnp.asarray(w), jnp.asarray(s), jnp.asarray(eids),
                                group_size=128, bm=16, out_dtype=jnp.float32)
    out = tmoe.w4a16_grouped_mm(t_(xk), t_(w), t_(s), t_(eids), group_size=128, bm=16, out_dtype=torch.float32)
    close(out, ref, 2e-5)
    s1 = s[:, :1]
    ref = jmoe.w4a16_grouped_mm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s1), jnp.asarray(eids),
                                group_size=128, bm=16, bk=128, out_dtype=jnp.float32, per_channel=True)
    out = tmoe.w4a16_grouped_mm(t_(x), t_(w), t_(s1), t_(eids), group_size=128, bm=16, out_dtype=torch.float32,
                                per_channel=True)
    close(out, ref, 2e-5)


@pytest.mark.parametrize("valid", [0, 1, 5, 8, 66])
@pytest.mark.parametrize("blocks", [1, 13, 132, 264])
@pytest.mark.parametrize("order", [w4a16_stream.ORDER_TILE, w4a16_stream.ORDER_KSYNC, w4a16_stream.ORDER_AUTO])
def test_w4a16_grouped_decode_unit_share(valid, blocks, order):
    """K11 at decode counts its units on the device from num_valid_blocks:
    (valid row block, 256-column tile, 256-deep k block). For any valid
    count, grid and order, every unit of the valid row blocks is taken
    exactly once and no unit of a padding block is; tile-major and k-sync
    shares differ by at most one unit, the automatic order's by at most one
    tile (Mixtral's down widths: 16 tiles, 56 k blocks)."""
    tiles, n_kb = w4a16_stream.tiles(4096), w4a16_stream.k_blocks(14336)
    shares = w4a16_stream.work_units(valid, tiles, n_kb, blocks, order)
    units = [u for share in shares for u in share]
    assert sorted(units) == [(t, kb) for t in range(valid * tiles) for kb in range(n_kb)]
    sizes = [len(share) for share in shares]
    assert max(sizes) - min(sizes) <= (n_kb if order == w4a16_stream.ORDER_AUTO else 1)


def test_bf16_grouped_mm_twin():
    bf16_twin_case(stacked=True)


def test_bf16_grouped_mm_twin_unstacked():
    bf16_twin_case(stacked=False)


def bf16_twin_case(stacked):
    """K12's twin against the Pallas kernel (interpret mode) on the rows of
    valid blocks, a stacked bank under layer_id or an unstacked one; a run
    of two blocks of one expert."""
    rng = np.random.default_rng(5)
    e, k, n, bm, blocks, nv = 4, 64, 96, 16, 4, 3
    x = rng.standard_normal((blocks * bm, k)).astype(np.float32)
    w = (rng.standard_normal((2, e, k, n) if stacked else (e, k, n)) * 0.1).astype(np.float32)
    eids = np.array([2, 0, 0, 3], np.int32)
    lid = 1 if stacked else None
    ref = jmoe.bf16_grouped_mm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(eids), lid, jnp.int32(nv), bm=bm)
    out = tmoe.bf16_grouped_mm(t_(x), t_(w), t_(eids), lid, torch.tensor(nv), bm=bm)
    close(out[: nv * bm], np.asarray(ref)[: nv * bm], 2e-5)
    assert tmoe.bf16_grouped_mm.launches == 0  # a CPU tensor takes the twin


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_grouped_mm(dtype):
    """ragged_grouped_mm against jax.lax.ragged_dot: groups of 5, 0, 11 and
    3 rows of 24, the last 5 rows in no group (zero)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((24, 48)).astype(np.float32)
    w = (rng.standard_normal((4, 48, 40)) * 0.2).astype(np.float32)
    gs = np.array([5, 0, 11, 3], np.int32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    ref = jmoe.ragged_grouped_mm(xj, wj, jnp.asarray(gs))
    out = tmoe.ragged_grouped_mm(t_(np.asarray(xj)), t_(np.asarray(wj)), t_(gs))
    assert out.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert not out[19:].any()
    # bf16 output: one rounding of a float32 sum on each side, one ulp apart
    close(out, np.asarray(ref, np.float32), 2e-5 if dtype == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("renorm", [True, False])
def test_topk_softmax(renorm):
    """Softmax top-2 and top-3 with tied logits: equal scores go to the
    lower expert id first, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(9)
    g = rng.standard_normal((33, 8)).astype(np.float32)
    g[:6] = np.round(g[:6])
    g[6:9, 2:6] = 0.5  # four experts tied at the top
    for k in (2, 3):
        jw, jids = jmoe.topk_softmax(jnp.asarray(g), k, renormalize=renorm)
        tw, tids = tmoe.topk_softmax(t_(g), k, renormalize=renorm)
        assert tids.dtype == torch.int32 and tw.dtype == torch.float32
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


def stacked_banks(rng, layers, e, h, inter, quant, gs=64):
    """Expert banks [L, E, H, 2I] / [L, E, I, H] (x @ W), quantized per
    expert the JAX model's way (quantize_w4 of W.T) when ``quant``."""
    w1 = (rng.standard_normal((layers, e, h, 2 * inter)) / np.sqrt(h)).astype(np.float32)
    w2 = (rng.standard_normal((layers, e, inter, h)) / np.sqrt(inter)).astype(np.float32)
    if not quant:
        return jmoe.MoeWeights(w1=jnp.asarray(w1), w2=jnp.asarray(w2), fmt="bf16")
    q = jax.vmap(jax.vmap(lambda m: jw4.quantize_w4(m.T, group_size=gs)[:2]))
    (p1, s1), (p2, s2) = q(jnp.asarray(w1)), q(jnp.asarray(w2))
    return jmoe.MoeWeights(w1=p1, w2=p2, w1_scales=s1, w2_scales=s2, fmt="int4", group_size=gs)


def port_weights(mw):
    return tmoe.MoeWeights(**{f: (t_(v) if hasattr(v, "shape") else v) for f, v in mw._asdict().items()
                              if v is not None})


@pytest.mark.parametrize("quant,t,biases", [(True, 5, False), (True, 70, False), (False, 9, False),
                                            (True, 9, True)])
def test_fused_experts_stacked(quant, t, biases):
    """One layer of stacked banks (int4 through K11's twin, bf16 through
    K12's), routed by biased top-k: ids equal first, then the outputs; with
    per-expert biases (stacked [L, E, ...]) before the activation and after
    the second GEMM."""
    rng = np.random.default_rng(6)
    layers, e, h, inter, k = 2, 8, 128, 64, 3
    mw = stacked_banks(rng, layers, e, h, inter, quant)
    if biases:
        mw = mw._replace(b1=jnp.asarray(rng.standard_normal((layers, e, 2 * inter)) * 0.1, jnp.bfloat16),
                         b2=jnp.asarray(rng.standard_normal((layers, e, h)) * 0.1, jnp.bfloat16))
    x = rng.standard_normal((t, h)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    bias = (rng.standard_normal(e) * 0.1).astype(np.float32)
    kw = dict(renormalize=True, routed_scaling_factor=2.5, apply_routed_scaling_factor_on_output=True)
    jtw, jids = jmoe.biased_topk(jnp.asarray(logits), jnp.asarray(bias), k, **kw)
    ttw, tids = tmoe.biased_topk(t_(logits), t_(bias), k, **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    xj = jnp.asarray(x, jnp.bfloat16) if quant else jnp.asarray(x)
    ref = jmoe.fused_experts(xj, mw, jtw, jids, layer_id=1)
    out = tmoe.fused_experts(t_(np.asarray(xj)), port_weights(mw), ttw, tids, layer_id=1)
    assert out.dtype == (torch.bfloat16 if quant else torch.float32)
    close(out, np.asarray(ref, np.float32), 2.0 ** -7 if quant else 2e-5)


def test_fused_experts_raises_on_unported_paths():
    """The unstacked bf16 call that raised before K12 was ported now runs:
    held to the JAX function (the cases below)."""
    test_fused_experts_unstacked_bf16(9, "f32")


@pytest.mark.parametrize("t", [2, 64, 70])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_experts_unstacked_bf16(t, dtype):
    """Unstacked bf16 banks, which raised before K12 was ported, against the
    JAX function on softmax top-2 routing: the grouped branch at up to 64
    tokens and ragged_dot's above (both sides take the same branch on the
    CPU). float32: 2e-5 of the scale; bf16: one rounding of the expert
    outputs and of the combine apart, 2^-7."""
    rng = np.random.default_rng(10)
    e, h, inter = 8, 128, 64
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    w1 = jnp.asarray(rng.standard_normal((e, h, 2 * inter)) / np.sqrt(h), jdt)
    w2 = jnp.asarray(rng.standard_normal((e, inter, h)) / np.sqrt(inter), jdt)
    x = jnp.asarray(rng.standard_normal((t, h)), jdt)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    jtw, jids = jmoe.topk_softmax(jnp.asarray(logits), 2, renormalize=True)
    ttw, tids = tmoe.topk_softmax(t_(logits), 2, renormalize=True)
    mw = jmoe.MoeWeights(w1=w1, w2=w2, fmt="bf16")
    ref = jmoe.fused_experts(x, mw, jtw, jids)
    out = tmoe.fused_experts(t_(np.asarray(x)), port_weights(mw), ttw, tids)
    assert out.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    close(out, np.asarray(ref, np.float32), 2e-5 if dtype == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh", "silu_clamp", "swiglu_gpt_oss"])
def test_activations(name):
    from sgl_kernel_tpu.ops.activation import ACTIVATIONS as JACT

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((6, 32)) * 4).astype(np.float32)
    # float32 on both sides; erf / tanh are other implementations: 1e-5 of the scale
    close(activation.ACTIVATIONS[name](t_(x)), JACT[name](jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("bm", [8, 16])
def test_w4a8_grouped_mm(zeros, bm):
    """w4a8_grouped_mm (K11 with unit per-channel scales, then the scale,
    zero and token epilogue) against JAX's on tests/test_moe.py's case:
    unsigned codes stored shifted, per-channel s1, bm 8 (the twin takes any
    bm; the card's K11 raises for it) and 16, with and without zeros.
    Tolerance: float32 sums in another order, 2e-5 of the scale."""
    rng = np.random.default_rng(21 + bm)
    e, n, k = 2, 128, 256
    cap = 3 * bm
    eids = np.array([0, 1, 1], np.int32)
    codes = rng.integers(0, 16, (e, n, k)).astype(np.uint8)
    signed = ((codes.astype(np.int32) - 8) & 0xF).astype(np.uint8)
    packed = np.stack([np.asarray(jw4.pack_w4_tpu(jnp.asarray(signed[i].T))) for i in range(e)])
    s1 = (rng.random((e, n)) * 0.02 + 0.01).astype(np.float32)
    szeros = (rng.random((e, n)) * 0.05).astype(np.float32) if zeros else None
    x = rng.integers(-100, 100, (cap, k)).astype(np.int8)
    xs = (rng.random(cap) * 0.01 + 0.005).astype(np.float32)
    ref = jmoe.w4a8_grouped_mm(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(packed), jnp.asarray(s1),
                               jnp.asarray(eids), None if szeros is None else jnp.asarray(szeros), bm=bm, bn=128,
                               out_dtype=jnp.float32)
    out = tmoe.w4a8_grouped_mm(t_(x), t_(xs), t_(packed), t_(s1), t_(eids), None if szeros is None else t_(szeros),
                               bm=bm, out_dtype=torch.float32)
    close(out, ref, 2e-5)
    assert tmoe.w4a8_grouped_mm(t_(x), t_(xs), t_(packed), t_(s1), t_(eids), bm=bm).dtype == torch.bfloat16


@pytest.mark.parametrize("bm,n,k,per_channel,expect", [
    (16, 256, 512, False, "stream"),
    (32, 2816, 2048, False, "stream"),
    (64, 256, 512, False, "wgmma"),
    (128, 2816, 2048, False, "wgmma"),   # V2-Lite gate_up at prefill
    (128, 4096, 14336, False, "wgmma"),  # Mixtral down
    (128, 256, 512, True, "wgmma"),      # per-channel scales (w4a8_grouped_mm's form)
    (16, 256, 512, True, "tile"),        # per-channel at decode: the mma.sync tile
    (64, 200, 512, False, "tile"),       # ragged N: TMA cannot map the codes
    (64, 256, 1376, False, "tile"),      # K of 43 groups of 32: a stage that ends in a quarter
    (64, 5760, 2880, False, "wgmma"),    # gpt-oss-20b gate_up: K = 22.5 stages of 128, groups of 32
    (128, 2880, 2880, False, "wgmma"),   # gpt-oss-20b down
    (16, 5760, 2880, False, "stream"),   # gpt-oss-20b gate_up at decode
])
def test_w4a16_grouped_route(bm, n, k, per_channel, expect):
    """K11's kernel by bm and bank: the streaming core at bm 16 / 32, the
    wgmma tile at bm 64 / 128, the mma.sync tile for the rest."""
    from sgl_kernel_tpu_torch.ops.moe import grouped_gemm

    gs = 32 if k % 128 else 128
    e = 3
    w = torch.zeros((e, k // 2, n), dtype=torch.uint8)
    s = torch.zeros((e, 1 if per_channel else k // gs, n), dtype=torch.bfloat16)
    if per_channel:
        s = s.expand(e, k // gs, n)
    assert grouped_gemm.grouped_route(bm, n, k, per_channel, w, s, None) == expect


def test_per_token_group_quant_fp4_bytes():
    """MXFP4 group quantization (E2M1 codes, UE8M0 group-32 scales) equal to
    JAX's byte for byte, at gpt-oss's K = 2,880, on groups whose absmax sits
    at, an ulp under and an ulp over a power of two, an all-zero group and
    rows of 1e-3 to 30 scale. The silu forms are held to the scales exactly
    and the codes up to rounding ties of silu (XLA's sigmoid and torch's
    differ by an ulp): at most 0.1 % of codes, each the same value (+0 and
    -0) or one magnitude step apart with the same sign."""
    from sgl_kernel_tpu.ops.quant import per_token_group_quant_fp4 as jq
    from sgl_kernel_tpu_torch.ops.quant import formats, per_token_group_quant_fp4 as tq

    rng = np.random.default_rng(21)
    x = (rng.standard_normal((48, 2880)) * rng.choice([1e-3, 1.0, 30.0], (48, 1))).astype(np.float32)
    x[0, :32] = 0.0
    for i, v in enumerate((8192.0, np.nextafter(np.float32(4.0), 0), np.float32(31.999996), 2.0 ** -20)):
        x[i + 1, 32:64] = v
    jp, js = jq(jnp.asarray(x))
    tp, ts = tq(t_(x))
    assert tp.dtype == ts.dtype == torch.uint8 and tuple(tp.shape) == (48, 1440) and tuple(ts.shape) == (48, 90)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    y = rng.standard_normal((48, 2880)).astype(np.float32)
    for args, kw in (((x, y), {}), ((np.concatenate([x, y], -1),), dict(fuse_silu_and_mul=True))):
        jp, js = jq(*map(jnp.asarray, args), **kw)
        tp, ts = tq(*map(t_, args), **kw)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jc = formats.unpack_int4(t_(np.asarray(jp))).long()
        tc = formats.unpack_int4(tp).long()
        flip = jc != tc
        zeros = (jc & 7) + (tc & 7) == 0
        step = ((jc >> 3) == (tc >> 3)) & (((jc & 7) - (tc & 7)).abs() == 1)
        assert flip.float().mean() < 1e-3 and (zeros | step)[flip].all()


@pytest.mark.parametrize("t", [5, 70])
def test_fused_experts_mxfp4_half_stage(t):
    """gpt-oss's MoE on stacked MXFP4 banks made the JAX model's way
    (per_token_group_quant_fp4 of W.T, mxfp4_to_tpu_layout) at hidden and
    intermediate widths of 192 = 128 + 64 (gpt-oss-20b's 2,880 ends the same
    way, in half a 128-deep stage), routed by softmax top-2 with expert
    biases and the clamped swiglu, bf16 activations: within two bf16
    roundings of the scale, 2^-6 (the swiglu's bf16 output may round the
    other way on the two sides, and the second GEMM and the combine each
    round once more; 2^-6.5 seen at 70 tokens)."""
    from sgl_kernel_tpu.ops.gemm.w4a16 import mxfp4_to_tpu_layout
    from sgl_kernel_tpu.ops.quant import per_token_group_quant_fp4

    rng = np.random.default_rng(22)
    layers, e, h, inter = 2, 4, 192, 192
    w1 = (rng.standard_normal((layers, e, h, 2 * inter)) / np.sqrt(h)).astype(np.float32)
    w2 = (rng.standard_normal((layers, e, inter, h)) / np.sqrt(inter)).astype(np.float32)
    q = jax.vmap(jax.vmap(lambda m: mxfp4_to_tpu_layout(*per_token_group_quant_fp4(m.T))))
    (p1, s1), (p2, s2) = q(jnp.asarray(w1)), q(jnp.asarray(w2))
    mw = jmoe.MoeWeights(w1=p1, w2=p2, w1_scales=s1, w2_scales=s2, fmt="mxfp4", group_size=32,
                         b1=jnp.asarray(rng.standard_normal((layers, e, 2 * inter)) * 0.1, jnp.float32),
                         b2=jnp.asarray(rng.standard_normal((layers, e, h)) * 0.1, jnp.float32))
    x = jnp.asarray(rng.standard_normal((t, h)), jnp.bfloat16)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    jtw, jids = jmoe.topk_softmax(jnp.asarray(logits), 2, renormalize=True)
    ttw, tids = tmoe.topk_softmax(t_(logits), 2, renormalize=True)
    kw = dict(layer_id=1, activation="swiglu_gpt_oss", gemm1_alpha=1.702, gemm1_limit=7.0)
    ref = jmoe.fused_experts(x, mw, jtw, jids, **kw)
    out = tmoe.fused_experts(t_(np.asarray(x)), port_weights(mw), ttw, tids, **kw)
    assert out.dtype == torch.bfloat16
    close(out, np.asarray(ref, np.float32), 2.0 ** -6)
