"""Label-smoothing loss (port of ``onnx_transformer_tpu/train/loss.py``).

KL divergence (sum reduction) between the model's log-probs and a smoothed
true distribution with
- off-target mass ``smoothing / (size - 2)``,
- ``confidence = 1 - smoothing`` at the target id,
- zero mass on the padding column,
- rows whose *target* is padding zeroed entirely,
normalised by the caller by the number of non-pad target tokens.
"""

from __future__ import annotations

import numpy as np
import torch


def smoothed_true_dist(targets: torch.Tensor, vocab_size: int, pad_id: int,
                       smoothing: float) -> torch.Tensor:
    """[N] int targets -> [N, V] smoothed distribution; the explicit form
    that :func:`label_smoothing_loss` computes in closed form."""
    confidence = 1.0 - smoothing
    fill = smoothing / (vocab_size - 2)
    dist = torch.full((*targets.shape, vocab_size), fill, dtype=torch.float32,
                      device=targets.device)
    dist.scatter_(-1, targets[..., None].long(), confidence)
    dist[..., pad_id] = 0.0
    return torch.where((targets == pad_id)[..., None], 0.0, dist)


def label_smoothing_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                         pad_id: int = 2, smoothing: float = 0.1) -> torch.Tensor:
    """Sum KLDiv(true_dist || exp(log_probs)) = Σ p (log p − log q), with
    0·log 0 := 0, for log_probs [N, V] and targets [N].

    Computed in closed form per row, never as a flat [N, V] reduction of the
    true distribution: a flat f32 sum of N·V tiny fill-mass terms underflows
    against its running total, while the per-row sums stay well inside f32.

      KL_row = [c·log c + (V-2)·f·log f]
             − [c·log q(t) + f·(Σ_j log q_j − log q(t) − log q(pad))]
      with c = 1 − smoothing, f = smoothing / (V - 2);
      rows whose target is pad contribute 0.
    """
    v = log_probs.shape[-1]
    confidence = 1.0 - smoothing
    fill = smoothing / (v - 2)
    # the entropy term Σ p log p, the same for every non-pad row
    plogp = float(np.float32(confidence * np.log(confidence)
                             + (v - 2) * fill * np.log(fill)))
    t = targets.long()
    logq_t = log_probs.gather(-1, t[:, None])[:, 0]
    logq_sum = log_probs.sum(-1)
    logq_pad = log_probs[:, pad_id]
    cross = confidence * logq_t + fill * (logq_sum - logq_t - logq_pad)
    kl_row = plogp - cross
    return torch.where(t == pad_id, 0.0, kl_row).sum()


def loss_and_ntokens(log_probs: torch.Tensor, tgt_y: torch.Tensor, pad_id: int = 2,
                     smoothing: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """(total KL loss, ntokens int32) of log_probs [B, T, V] against tgt_y
    [B, T]; loss / ntokens is the training objective."""
    v = log_probs.shape[-1]
    flat_t = tgt_y.reshape(-1)
    loss = label_smoothing_loss(log_probs.reshape(-1, v), flat_t, pad_id, smoothing)
    return loss, (flat_t != pad_id).sum(dtype=torch.int32)
