"""Mamba-2 SSD layer (the counterpart of ``repro.models.ssm``).

Only the depthwise causal convolution is ported so far, because the
RG-LRU block uses it; the SSD layer itself, with its ``ssd_scan`` kernel,
comes with mamba2-2.7b (ROADMAP A4.1).
"""
from __future__ import annotations

import torch.nn.functional as F


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    return out
