"""Mamba-style causal depthwise conv1d: a padded-batch prefill with a
carried state, and the one-token decode update
(sgl_kernel_tpu/ops/linear_attn/causal_conv1d.py:31-94). The front end of
the GDN layers. The width is 2-4, so the conv is a sum of W shifted slices,
summed in the JAX function's order, in float32."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _act(x, activation):
    if activation is None or activation == "none":
        return x
    if activation in ("silu", "swish"):
        return x * torch.sigmoid(x)
    raise ValueError(activation)


def causal_conv1d_fwd(x, weight, bias=None, seq_lens=None, initial_states=None, *,
                      activation: Optional[str] = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D]; weight [D, W]; bias [D]; seq_lens [B]; initial_states
    [B, W-1, D] (the last W-1 inputs of the previous chunk). Inputs at or
    past a sequence's length are zeroed first, so padding never reaches a
    state. Returns (y [B, S, D], final_states [B, W-1, D]): the final state
    is each sequence's last W-1 valid inputs (rows [len, len + W-1) of the
    state-padded input)."""
    b, s, d = x.shape
    w = weight.shape[1]
    dev = x.device
    seq_lens = (torch.full((b,), s, dtype=torch.long, device=dev) if seq_lens is None
                else seq_lens.to(dev, torch.long))
    tmask = (torch.arange(s, device=dev)[None, :] < seq_lens[:, None])[..., None]
    xf = torch.where(tmask, x.float(), 0.0)
    pad = (torch.zeros((b, w - 1, d), dtype=torch.float32, device=dev) if initial_states is None
           else initial_states.float())
    xpad = torch.cat([pad, xf], dim=1)  # [B, S+W-1, D]
    wf = weight.float()
    y = torch.zeros((b, s, d), dtype=torch.float32, device=dev)
    for j in range(w):
        y = y + xpad[:, j: j + s] * wf[:, j][None, None, :]
    if bias is not None:
        y = y + bias.float()[None, None, :]
    y = torch.where(tmask, _act(y, activation), 0.0)
    idx = seq_lens[:, None] + torch.arange(w - 1, device=dev)[None, :]  # [B, W-1]
    final = xpad.gather(1, idx[..., None].expand(b, w - 1, d))
    return y.to(x.dtype), final.to(x.dtype)


def causal_conv1d_update(x, conv_state, weight, bias=None, *,
                         activation: Optional[str] = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x [B, D]; conv_state [B, W-1, D]. Returns (y [B, D],
    new_conv_state [B, W-1, D]): the window is the state and x, and the new
    state its last W-1 rows."""
    window = torch.cat([conv_state.float(), x.float()[:, None, :]], dim=1)  # [B, W, D]
    y = torch.einsum("bwd,dw->bd", window, weight.float())
    if bias is not None:
        y = y + bias.float()
    y = _act(y, activation)
    return y.to(x.dtype), window[:, 1:].to(conv_state.dtype)
