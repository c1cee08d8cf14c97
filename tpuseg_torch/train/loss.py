"""Loss functions (counterpart of ``tpuseg/train/loss.py``).

- segmentation: CrossEntropyLoss(ignore_index=255) applied to the model's
  log-softmax output (semantic_seg.py:817,197-198).  log_softmax is
  idempotent, so CE-on-log-probs == NLL-of-log-probs; we take NLL directly.
- knowledge distillation: KL(log_softmax(student/T) || softmax(teacher/T)),
  summed over classes, averaged over batch, mixed with the hard CE
  (rmbsnn_main.py:459-469; default weights 0.5/0.5, temperature 4.0 per
  flags rmbsnn_main.py:106-110).

Every loss is computed in f32 and returns a 0-d tensor.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = 255


def _masked_nll(logp: torch.Tensor, labels: torch.Tensor, ignore_index: int) -> torch.Tensor:
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    picked = logp.gather(-1, safe[..., None])[..., 0]
    nll = -torch.where(valid, picked, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def seg_loss_from_logprobs(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over non-ignored pixels.

    ``logp``: (N, H, W, C) log-probabilities.  ``labels``: (N, H, W) int.
    """
    return _masked_nll(logp, labels, IGNORE_INDEX)


def cross_entropy_ignore(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX
) -> torch.Tensor:
    """CE from raw logits with an ignore index (classification uses
    ignore-free labels; segmentation may pass 255)."""
    return _masked_nll(torch.log_softmax(logits.float(), dim=-1), labels, ignore_index)


def kd_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    temperature: float = 4.0,
) -> torch.Tensor:
    """Distillation term: KL of temperature-softened distributions, summed
    over classes and batch then divided by batch size (matching
    ``F.kl_div(..., size_average=False) / batch`` in rmbsnn_main.py:467)."""
    t = temperature
    s_logp = torch.log_softmax(student_logits.float() / t, dim=-1)
    t_prob = torch.softmax(teacher_logits.detach().float() / t, dim=-1)
    kl = t_prob * (torch.log(t_prob.clamp(min=1e-30)) - s_logp)
    return kl.sum() / student_logits.shape[0]


def combined_kd_loss(
    student_logits,
    labels,
    teacher_logits,
    student_wt: float = 0.5,
    distill_wt: float = 0.5,
    temperature: float = 4.0,
):
    # classification labels have no ignore value (the reference's hard term
    # is a plain CrossEntropyLoss, rmbsnn_main.py:459-462) — the seg default
    # of 255 would silently drop class-255 samples on >=256-class datasets
    hard = cross_entropy_ignore(student_logits, labels, ignore_index=-1)
    soft = kd_loss(student_logits, teacher_logits, temperature)
    return student_wt * hard + distill_wt * soft
