"""Parity of the port's packed flash prefill (K9's module) with the JAX
package: the host packing helpers byte for byte, and the plain twin of
``flash_attention_packed`` against the Pallas kernel in interpret mode on
the same numpy-seeded bytes; then K7's base-2 lse against JAX's
``return_lse``. Only rows that see a key are compared where the two sides
define degenerate rows differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.attention import flash_packed as jpacked
from sgl_kernel_tpu.ops.attention import flash_prefill as jflash
from sgl_kernel_tpu_torch.interop import tensor_from_numpy
from sgl_kernel_tpu_torch.ops.attention import flash_packed as tpacked
from sgl_kernel_tpu_torch.ops.attention import flash_prefill as tflash

torch.set_num_threads(1)

# float32 inputs: the Pallas kernel runs an online softmax over tiles, the
# twin one dense softmax per block; the sums differ in order and in where
# the running max rescales, a few float32 ulp per term.
F32 = dict(rtol=2e-5, atol=2e-5)
# bf16 inputs: the Pallas kernel rounds the probabilities to bf16 before
# the P.V product (2^-8 relative), the twin keeps them in float32.
BF16 = dict(rtol=2e-2, atol=2e-2)
BLOCK = 128  # the contract's block; small to keep the interpret-mode grid short


def both(x, jdt):
    xj = jnp.asarray(x, jdt)
    return xj, tensor_from_numpy(np.asarray(xj), "cpu")


def close(a_jax, b_torch, **tol):
    np.testing.assert_allclose(np.asarray(a_jax, np.float32), b_torch.float().numpy(), **tol)


@pytest.mark.parametrize("q_lens,kv_lens", [([5, 256, 1, 300], None), ([16, 40], [100, 40]), ([0, 7], [3, 7])])
@pytest.mark.parametrize("block", [128, 256])
def test_packing_helpers_bytes(rng, q_lens, kv_lens, block):
    jm = jpacked.build_packed_metadata(q_lens, kv_lens, block=block)
    tm = tpacked.build_packed_metadata(q_lens, kv_lens, block=block)
    assert sorted(jm) == sorted(tm)
    for key, val in jm.items():
        if isinstance(val, np.ndarray):
            assert val.dtype == tm[key].dtype, key
            np.testing.assert_array_equal(val, tm[key])
        else:
            assert type(val) is type(tm[key]) and val == tm[key], key
    js, _ = jpacked.make_seq_meta(q_lens, kv_lens, block=block)
    ts, _ = tpacked.make_seq_meta(q_lens, kv_lens, block=block)
    assert js.dtype == ts.dtype and js.shape == ts.shape
    np.testing.assert_array_equal(js, ts)
    s = max(q_lens) + 3
    x = rng.standard_normal((len(q_lens), s, 2, 4)).astype(np.float32)
    xj, xt = both(x, jnp.bfloat16)
    pj, _ = jpacked.pack_padded(xj, q_lens, block=block)
    pt, _ = tpacked.pack_padded(xt, q_lens, block=block)
    assert tuple(pj.shape) == tuple(pt.shape)
    np.testing.assert_array_equal(np.asarray(pj).view(np.uint16), pt.view(torch.int16).numpy().view(np.uint16))
    uj = jpacked.unpack_to_padded(pj, q_lens, s, block=block)
    ut = tpacked.unpack_to_padded(pt, q_lens, s, block=block)
    np.testing.assert_array_equal(np.asarray(uj).view(np.uint16), ut.view(torch.int16).numpy().view(np.uint16))


def packed_case(rng, q_lens, kv_lens, hq, hkv, d, jdt=jnp.float32, n_pad_blocks=0, **meta_kw):
    """Packed q/k/v for sequences of q_lens over kv_lens, plus n_pad_blocks
    padding q blocks pointing at an empty pseudo-sequence row (the engine's
    padding: q_len 0, kv_blks 1)."""
    seq_meta, meta = tpacked.make_seq_meta(q_lens, kv_lens, block=BLOCK, **meta_kw)
    blk_seq, blk_q0 = meta["blk_seq"], meta["blk_q0"]
    if n_pad_blocks:
        pad_row = np.array([[0, 0, 0, 0, 0, 1]], np.int32)
        seq_meta = np.concatenate([seq_meta, pad_row])
        blk_seq = np.concatenate([blk_seq, np.full(n_pad_blocks, len(q_lens), np.int32)])
        blk_q0 = np.concatenate([blk_q0, np.zeros(n_pad_blocks, np.int32)])
    tpq = meta["total_q"] + n_pad_blocks * BLOCK
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((tpq, hq, d), (meta["total_kv"], hkv, d), (meta["total_kv"], hkv, d))]
    ints = [(jnp.asarray(a), torch.from_numpy(a)) for a in (blk_seq, blk_q0, seq_meta)]
    return [both(a, jdt) for a in arrs], ints, meta


def run_both(qkv, ints, max_kvb, **kw):
    (qj, qt), (kj, kt), (vj, vt) = qkv
    (bsj, bst), (b0j, b0t), (smj, smt) = ints
    sinks = kw.pop("sinks", None)
    ref = jpacked.flash_attention_packed(qj, kj, vj, bsj, b0j, smj, max_kvb=max_kvb, block=BLOCK,
                                         sinks=None if sinks is None else jnp.asarray(sinks), **kw)
    out = tpacked.flash_attention_packed(qt, kt, vt, bst, b0t, smt, max_kvb=max_kvb, block=BLOCK,
                                         sinks=None if sinks is None else torch.from_numpy(sinks), **kw)
    return ref, out


def valid_rows(q_lens, meta):
    """Packed row indices of every sequence's rows r < q_len."""
    return np.concatenate([t0 + np.arange(n) for t0, n in zip(meta["seq_tok0"], q_lens)]).astype(np.int64)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_packed_causal_gqa(rng, hq, hkv):
    """Causal self-attention of a ragged batch, GQA groups 1 and 4, with
    the lse; rows past q_len of each sequence see no key on both sides."""
    q_lens = [130, 5, 256, 1]
    qkv, ints, meta = packed_case(rng, q_lens, None, hq, hkv, 32)
    (ro, rl), (oo, ol) = run_both(qkv, ints, meta["max_kvb"], causal=True, return_lse=True)
    assert oo.shape == qkv[0][1].shape and ol.shape == (hq, meta["total_q"]) and ol.dtype == torch.float32
    rows = valid_rows(q_lens, meta)
    close(np.asarray(ro)[rows], oo[rows], **F32)
    close(np.asarray(rl)[:, rows], ol[:, rows], **F32)
    # rows past q_len: o = 0 and a finite lse on the port's side
    pad = np.setdiff1d(np.arange(meta["total_q"]), rows)
    assert not oo[pad].any() and torch.isfinite(ol).all()
    assert torch.all(ol[:, pad] == np.float32(-1e30 * tflash.LOG2E))


def test_packed_extend_offsets(rng):
    """Chunked-extend metadata: q as the last q_len of kv_len (the default
    q_start), then explicit q_start / kv_start, bf16."""
    q_lens, kv_lens = [40, 17], [200, 17]
    qkv, ints, meta = packed_case(rng, q_lens, kv_lens, 4, 2, 64, jdt=jnp.bfloat16)
    rows = valid_rows(q_lens, meta)
    ro, oo = run_both(qkv, ints, meta["max_kvb"], causal=True)
    close(np.asarray(ro)[rows], oo[rows], **BF16)
    qkv, ints, meta = packed_case(rng, q_lens, kv_lens, 4, 2, 64, jdt=jnp.bfloat16,
                                  q_start=[180, 5], kv_start=[10, 0])
    (ro, rl), (oo, ol) = run_both(qkv, ints, meta["max_kvb"], causal=True, return_lse=True)
    close(np.asarray(ro)[rows], oo[rows], **BF16)
    close(np.asarray(rl)[:, rows], ol[:, rows], **BF16)


@pytest.mark.parametrize("causal", [True, False])
def test_packed_window_softcap_sinks(rng, causal):
    """The options beyond the kernel's: sliding window, tanh softcap and
    per-head sinks (added to the denominator once), with the lse."""
    q_lens = [150, 60]
    hq = 4
    qkv, ints, meta = packed_case(rng, q_lens, None, hq, 2, 32)
    sinks = rng.standard_normal(hq).astype(np.float32)
    (ro, rl), (oo, ol) = run_both(qkv, ints, meta["max_kvb"], causal=causal, sliding_window=48,
                                  logit_soft_cap=5.0, sinks=sinks, return_lse=True)
    rows = valid_rows(q_lens, meta)
    close(np.asarray(ro)[rows], oo[rows], **F32)
    close(np.asarray(rl)[:, rows], ol[:, rows], **F32)


@pytest.mark.parametrize("opt", ["sinks", "window", "softcap", "all"])
def test_packed_options_offsets(rng, opt):
    """K9's twin with each of gpt-oss's options alone and together, at
    extend offsets (q_start 180 / 60 over kv_start 10 / 0), GQA 8:1, with
    the lse. Sequence 2's rows sit past its 40 keys' window of 12 and see
    none: the port gives them o = 0 and lse -1e30 * log2(e) (ROADMAP queue 3);
    rows that see a key are compared."""
    q_lens, kv_lens = [40, 17], [200, 40]
    hq = 8
    kw = {"sinks": dict(sinks=True), "window": dict(sliding_window=12), "softcap": dict(logit_soft_cap=5.0),
          "all": dict(sinks=True, sliding_window=12, logit_soft_cap=5.0)}[opt]
    qkv, ints, meta = packed_case(rng, q_lens, kv_lens, hq, 1, 32, q_start=[180, 60], kv_start=[10, 0])
    if kw.pop("sinks", False):
        kw["sinks"] = (rng.standard_normal(hq) * 2).astype(np.float32)
    (ro, rl), (oo, ol) = run_both(qkv, ints, meta["max_kvb"], causal=True, return_lse=True, **kw)
    seq0 = valid_rows(q_lens[:1], meta)
    close(np.asarray(ro)[seq0], oo[seq0], **F32)
    close(np.asarray(rl)[:, seq0], ol[:, seq0], **F32)
    seq1 = meta["seq_tok0"][1] + np.arange(q_lens[1])
    if "sliding_window" in kw:
        assert not oo[seq1].any() and torch.all(ol[:, seq1] == np.float32(-1e30 * tflash.LOG2E))
    else:
        close(np.asarray(ro)[seq1], oo[seq1], **F32)
        close(np.asarray(rl)[:, seq1], ol[:, seq1], **F32)


def test_packed_padding_pseudo_sequence(rng):
    """The engine's layout: the block count padded to a power of two, the
    padding blocks on a q_len-0 row with kv_blks 1, and max_kvb above every
    sequence's kv block count. Padding rows write zeros and a finite lse."""
    q_lens = [100, 200, 3]
    qkv, ints, meta = packed_case(rng, q_lens, None, 4, 2, 32, n_pad_blocks=4)
    (ro, rl), (oo, ol) = run_both(qkv, ints, 4, causal=True, return_lse=True)
    rows = valid_rows(q_lens, meta)
    close(np.asarray(ro)[rows], oo[rows], **F32)
    close(np.asarray(rl)[:, rows], ol[:, rows], **F32)
    pad = slice(meta["total_q"], None)
    assert not oo[pad].any() and torch.isfinite(ol[:, pad]).all()
    # the twin's layout rules: metadata built for another block raises
    with pytest.raises(ValueError):
        tpacked.flash_attention_packed(qkv[0][1], qkv[1][1], qkv[2][1], *(t for _, t in ints), max_kvb=4,
                                       block=2 * BLOCK)


def test_packed_576_group16(rng):
    """K9 at head dim 576, DeepSeek's packed MLA prefill: 16 heads over one
    latent KV head, two prompts and a padding block, V the latent's first
    512 columns zero-padded to 576 on JAX's side. The public twin against
    the Pallas kernel in interpret mode on the same bytes, and the MLA
    entry (V read as K's first 512 columns, 512-wide output) and its twin
    equal to the public twin's first 512 columns; float32 (F32: another
    summation order), lse to 1e-4."""
    q_lens = [150, 37]
    qkv, ints, meta = packed_case(rng, q_lens, None, 16, 1, 576, n_pad_blocks=1)
    (qj, qt), (kj, kt), _ = qkv
    vj = jnp.pad(kj[..., :512], ((0, 0), (0, 0), (0, 64)))
    vt = torch.nn.functional.pad(kt[..., :512], (0, 64))
    (bsj, bst), (b0j, b0t), (smj, smt) = ints
    kw = dict(max_kvb=4, causal=True, sm_scale=0.05, return_lse=True, block=BLOCK)
    ro, rl = jpacked.flash_attention_packed(qj, kj, vj, bsj, b0j, smj, **kw)
    before = tpacked.flash_attention_packed.launches_576
    oo, ol = tpacked.flash_attention_packed(qt, kt, vt, bst, b0t, smt, **kw)
    rows = valid_rows(q_lens, meta)
    close(np.asarray(ro)[rows], oo[rows], **F32)
    np.testing.assert_allclose(np.asarray(rl)[:, rows], ol[:, rows].numpy(), rtol=1e-5, atol=1e-4)
    assert not oo[~torch.from_numpy(np.isin(np.arange(oo.shape[0]), rows))].any()
    for fn in (tpacked.flash_attention_packed_mla, tpacked.flash_attention_packed_mla_ref):
        mo, ml = fn(qt[..., :512], qt[..., 512:], kt, bst, b0t, smt, **kw)
        assert mo.shape == (oo.shape[0], 16, 512)
        # the same sums over 512 instead of 576 value columns: at most another summation order
        torch.testing.assert_close(mo, oo[..., :512], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(ml, ol, rtol=1e-6, atol=1e-6)
    assert tpacked.flash_attention_packed.launches_576 == before  # CPU tensors: the twins, no launch


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1)])
def test_flash_prefill_lse(rng, hq, hkv):
    """K7's twin: the base-2 lse of the extend passes against JAX
    return_lse: fresh rows causal at global offsets (every row sees a key),
    and a prefix pass with one sequence whose prefix is empty (its rows see
    no key: o = 0, lse -1e30 * log2(e) on the port's side)."""
    b, sq, skv, d = 2, 24, 40, 32
    (qj, qt), (kj, kt), (vj, vt) = [both(rng.standard_normal(sh).astype(np.float32), jnp.float32)
                                    for sh in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    q_lens = np.array([24, 9], np.int32)
    pre = np.array([16, 0], np.int32)
    args_j = [jnp.asarray(a) for a in (q_lens, pre)]
    args_t = [torch.from_numpy(a) for a in (q_lens, pre)]
    # pass 2 of prefill_extend: prefix keys, kv_len = prefix length
    ro, rl = jflash.flash_attention(qj, kj, vj, args_j[0], args_j[1], None, args_j[1], jnp.zeros(2, jnp.int32),
                                    causal=True, return_lse=True, block_q=8, block_kv=128)
    oo, ol = tflash.flash_attention(qt, kt, vt, args_t[0], args_t[1], None, args_t[1], torch.zeros(2, dtype=torch.int32),
                                    causal=True, return_lse=True)
    assert ol.shape == (b, hq, sq) and ol.dtype == torch.float32
    close(ro[0], oo[0], **F32)
    close(rl[0], ol[0], **F32)
    assert not oo[1].any() and torch.all(ol[1] == np.float32(-1e30 * tflash.LOG2E))
    # pass 1: the fresh rows at global offsets pre
    ro, rl = jflash.flash_attention(qj, kj, vj, args_j[0], args_j[0], None, args_j[1], args_j[1],
                                    causal=True, return_lse=True, block_q=8, block_kv=128)
    oo, ol = tflash.flash_attention(qt, kt, vt, args_t[0], args_t[0], None, args_t[1], args_t[1],
                                    causal=True, return_lse=True)
    for i, n in enumerate(q_lens):
        close(ro[i, :n], oo[i, :n], **F32)
        close(rl[i, :, :n], ol[i, :, :n], **F32)
