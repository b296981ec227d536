"""Model-side utilities: counterpart of triton_dist_tpu/models/utils.py
(greedy sampling only so far)."""

from __future__ import annotations

import torch


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the first maximal logit along the last axis."""
    return torch.argmax(logits, dim=-1)
