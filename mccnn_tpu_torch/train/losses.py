"""Training criterions (mccnn_tpu/train/losses.py).

- hinge: the fast arch's Margin2 (adcensus.cu:1379-1453, Margin2.lua)
  over interleaved (pos, neg) similarity pairs; `pow=2` uses the
  squared-hinge functor (note its 0.5 factor, adcensus.cu:1398-1400).
- bce: the slow arch's BCECriterion2 (BCECriterion2.lua) with eps=1e-12
  inside the logs, mean over the batch.
"""

from __future__ import annotations

import torch


def hinge(scores: torch.Tensor, margin: float = 0.2, pow: int = 1
          ) -> torch.Tensor:
    """scores: (2B,) interleaved [pos, neg, pos, neg, ...] similarities
    (higher = more similar). Loss = mean_i max(0, neg_i - pos_i + m)."""
    pos = scores[0::2]
    neg = scores[1::2]
    f = torch.clamp_min(neg - pos + margin, 0.0)
    if pow == 2:
        f = 0.5 * f * f
    return f.mean()


def bce(p: torch.Tensor, target: torch.Tensor, eps: float = 1e-12
        ) -> torch.Tensor:
    """p: (B,) sigmoid outputs; target: (B,) in {0,1} (0 = match,
    main.lua:848-849). Mean negative log-likelihood with eps clamping
    matching BCECriterion2.lua."""
    t1 = torch.log(p + eps) * target
    t2 = torch.log1p(-p + eps) * (1.0 - target)
    return -(t1 + t2).mean()
