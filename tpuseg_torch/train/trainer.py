"""Train and eval steps (counterpart of ``tpuseg/train/trainer.py``).

One functional core: ``(state, images, labels) -> (state', metrics)``.  The
masked-weight projection runs right after every optimizer update (the
reference re-applies masks after every ``optimizer.step()``:
semantic_seg.py:213-214, rmbsnn_main.py:483-484).  PyTorch runs the step
eagerly; there is no trace to compile.

``make_cls_train_step`` and ``classifier_forward`` belong to the classifier
arm, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from tpuseg_torch.models.drn import DrnSpec
from tpuseg_torch.models.drnseg import drnseg_forward
from tpuseg_torch.sparsity import apply_masks
from tpuseg_torch.train.loss import seg_loss_from_logprobs
from tpuseg_torch.train.optim import Sgd


@dataclasses.dataclass
class TrainState:
    params: dict
    bn_state: dict
    opt_state: tuple
    masks: dict
    step: int


def create_train_state(params, bn_state, tx: Sgd, masks=None) -> TrainState:
    """The initial state: params masked (when there are masks), the
    optimizer's zero state, step 0.  Tensors are used as given: move them to
    the device first."""
    params = dict(params)
    masks = dict(masks or {})
    if masks:
        params = apply_masks(params, masks)
    return TrainState(params=params, bn_state=dict(bn_state), opt_state=tx.init(params),
                      masks=masks, step=0)


@torch.no_grad()
def _sgd_update(tx: Sgd, grads, state: TrainState, frozen: tuple[str, ...] = ()):
    updates, new_opt = tx.update(grads, state.opt_state, state.params)
    # Frozen params are excluded from the optimizer in the reference
    # (DRNSeg.optim_parameters skips the upsampler, semantic_seg.py:160-164),
    # so they see neither gradient nor weight decay; their momentum trace
    # still takes wd * p, as tpuseg's does.
    new_params = {k: (p if k in frozen else p + updates[k]) for k, p in state.params.items()}
    if state.masks:
        new_params = apply_masks(new_params, state.masks)
    return new_params, new_opt


def make_seg_train_step(
    spec: DrnSpec,
    tx: Sgd,
    compute_dtype=torch.bfloat16,
    frozen: tuple[str, ...] = ("up.weight",),
    remat: bool = False,
    sparse_plans: Mapping | None = None,
) -> Callable:
    """Segmentation train step (parity with semantic_seg.train).

    ``frozen`` params get zero gradients (the reference freezes the bilinear
    upsampler, semantic_seg.py:151, and excludes it from optim_parameters);
    no gradient is computed for them.

    ``remat=True`` recomputes each backbone stage in the backward pass
    (``drn_forward``): lower peak memory for ~1/3 more forward work, the
    same arithmetic.

    ``sparse_plans`` maps conv names to ``SparseTrainPlan``s on the
    images' device (``SparseTrainStruct.to`` of each struct
    ``tpuseg_torch.ops.sparse_train.build_sparse_train_structs`` makes):
    those convs run the forward and the dgrad through kernel B2 and the
    wgrad on the support, at the mask's union block density.  The
    trajectory of unmasked weights equals the masked-dense step's up to
    float associativity.
    """
    if sparse_plans:
        from tpuseg_torch.ops.sparse_train import SparseTrainPlan

        bad = [k for k, v in sparse_plans.items() if not isinstance(v, SparseTrainPlan)]
        if bad:
            raise TypeError(f"sparse_plans {bad}: want SparseTrainPlans "
                            "(SparseTrainStruct.to(device))")

    def loss_fn(params, bn_state, images, labels):
        logp, _seg, updates = drnseg_forward(
            params, bn_state, images, spec, train=True, compute_dtype=compute_dtype,
            remat=remat, sparse_plans=sparse_plans or None,
        )
        return seg_loss_from_logprobs(logp, labels), updates

    def train_step(state: TrainState, images, labels):
        params = {k: v.detach().requires_grad_(k not in frozen)
                  for k, v in state.params.items()}
        loss, bn_updates = loss_fn(params, state.bn_state, images, labels)
        names = [k for k in params if k not in frozen]
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        grads.update({k: torch.zeros_like(state.params[k]) for k in frozen if k in params})
        grads = {k: grads[k] for k in state.params}
        new_params, new_opt = _sgd_update(tx, grads, state, frozen)
        new_state = TrainState(
            params=new_params,
            bn_state={**state.bn_state, **bn_updates},
            opt_state=new_opt,
            masks=state.masks,
            step=state.step + 1,
        )
        # no predictions in the metrics: evaluation computes them
        return new_state, {"loss": loss.detach()}

    return train_step


def make_eval_step(spec, kind: str = "seg", compute_dtype=torch.bfloat16):
    """Eval step returning the per-batch loss and predictions (segmentation;
    the classifier kind waits for the classifier arm)."""
    if kind != "seg":
        raise NotImplementedError("make_eval_step(kind='cls'): the classifier arm is not "
                                  "ported yet (ROADMAP A20)")

    @torch.inference_mode()
    def eval_step(params, bn_state, images, labels):
        logp, _seg, _ = drnseg_forward(params, bn_state, images, spec, train=False,
                                       compute_dtype=compute_dtype)
        return seg_loss_from_logprobs(logp, labels), logp.argmax(dim=-1)

    return eval_step
