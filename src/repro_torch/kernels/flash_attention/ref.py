"""Plain PyTorch oracle for flash attention (layout [B, H, S, D]).

The twin of the JAX oracle: scores, softmax and the P·V product in float32,
the output cast to ``q``'s dtype.  Grouped-query heads go through a
``[B, Hkv, G, ...]`` reshape, so k and v are never repeated G times.  With
``causal``, key j is visible to query i when j <= i, aligned at position 0
also when Sq != Skv.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: [B, H, Sq, D]; k/v: [B, Hkv, Skv, D] (H % Hkv == 0) -> [B, H, Sq, D]."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)
