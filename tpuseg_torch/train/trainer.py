"""Train and eval steps (counterpart of ``tpuseg/train/trainer.py``).

One functional core: ``(state, images, labels) -> (state', metrics)``.  The
masked-weight projection runs right after every optimizer update (the
reference re-applies masks after every ``optimizer.step()``:
semantic_seg.py:213-214, rmbsnn_main.py:483-484).  PyTorch runs the step
eagerly; there is no trace to compile.

``classifier_forward`` and ``make_cls_train_step`` are the classifier arm's
(DRN classifiers and the CIFAR zoo, with knowledge distillation).

Every train step takes an optional ``ranks``
(``tpuseg_torch.parallel.mesh.Ranks``, which ``shard_train_step`` passes):
the step then runs on this rank's part of a global batch with the
unsharded step's semantics: BatchNorm statistics of the global batch, each
rank's loss its sum over the global count, and the gradients summed over
the ranks with one flat all-reduce before the update, so every replica
takes the same update.  Without it the step is the one-device step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from tpuseg_torch.metrics.profiling import span
from tpuseg_torch.models.drn import DrnSpec, drn_forward
from tpuseg_torch.models.drnseg import drnseg_forward
from tpuseg_torch.sparsity import apply_masks
from tpuseg_torch.train.loss import (
    combined_kd_loss,
    cross_entropy_ignore,
    seg_loss_from_logprobs,
)
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


def _total(loss: torch.Tensor, ranks) -> torch.Tensor:
    """The global batch's loss: the ranks' parts summed (each is its sum
    over the global count)."""
    return ranks.total(loss) if ranks is not None else loss


def _check_train_plans(sparse_plans: Mapping | None) -> None:
    if sparse_plans:
        from tpuseg_torch.ops.sparse_train import SparseTrainPlan

        bad = [k for k, v in sparse_plans.items() if not isinstance(v, SparseTrainPlan)]
        if bad:
            raise TypeError(f"sparse_plans {bad}: want SparseTrainPlans "
                            "(SparseTrainStruct.to(device))")


def _grads(loss: torch.Tensor, params: dict, state_params: dict,
           frozen: tuple[str, ...] = (), ranks=None) -> dict:
    """d loss / d param for every param of the state (zeros for frozen or
    unused ones), in the state's key order; with ``ranks`` summed over the
    ranks (one flat all-reduce)."""
    names = [k for k in params if k not in frozen]
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: (torch.zeros_like(params[k]) if g is None else g)
             for k, g in zip(names, grads)}
    grads.update({k: torch.zeros_like(state_params[k]) for k in frozen if k in params})
    grads = {k: grads[k] for k in state_params}
    return ranks.sum_grads(grads) if ranks is not None else grads


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
    _check_train_plans(sparse_plans)

    def loss_fn(params, bn_state, images, labels, ranks):
        logp, _seg, updates = drnseg_forward(
            params, bn_state, images, spec, train=True, compute_dtype=compute_dtype,
            remat=remat, sparse_plans=sparse_plans or None, ranks=ranks,
        )
        return seg_loss_from_logprobs(logp, labels, ranks), updates

    def train_step(state: TrainState, images, labels, ranks=None):
        dev = images.device
        with span("train.step"):
            params = {k: v.detach().requires_grad_(k not in frozen)
                      for k, v in state.params.items()}
            with span("train.forward", device=dev):
                loss, bn_updates = loss_fn(params, state.bn_state, images, labels, ranks)
            with span("train.backward", device=dev):
                grads = _grads(loss, params, state.params, frozen, ranks)
            with span("train.update", device=dev):
                new_params, new_opt = _sgd_update(tx, grads, state, frozen)
        new_state = TrainState(
            params=new_params,
            bn_state={**state.bn_state, **bn_updates},
            opt_state=new_opt,
            masks=state.masks,
            step=state.step + 1,
        )
        # no predictions in the metrics: evaluation computes them
        return new_state, {"loss": _total(loss.detach(), ranks)}

    return train_step


def classifier_forward(spec, compute_dtype=None, remat: bool = False,
                       sparse_plans: Mapping | None = None) -> Callable:
    """Uniform classifier forward ``(params, bn_state, x, train=False) ->
    (logits, bn_updates)`` for DRN and CIFAR-zoo specs.

    ``remat=True`` recomputes each backbone stage (DRN) or stage group
    (CIFAR zoo) in the backward pass.  ``sparse_plans`` (``SparseTrainPlan``s
    on the images' device) route masked convs through the trainable
    block-sparse conv, kernel B2 in the forward and the dgrad; DRN specs
    only: ``build_sparse_train_structs`` walks only a ``DrnSpec``'s
    stages."""
    from tpuseg_torch.models.cifar import CifarSpec, cifar_forward

    if isinstance(spec, CifarSpec):
        if sparse_plans:
            raise ValueError(
                "sparse_plans is not supported for CIFAR-zoo specs: "
                "build_sparse_train_structs walks only a DrnSpec's stages")

        def fwd(params, bn_state, x, train=False, ranks=None):
            return cifar_forward(params, bn_state, x, spec, train=train,
                                 compute_dtype=compute_dtype, remat=remat, ranks=ranks)

    else:
        _check_train_plans(sparse_plans)

        def fwd(params, bn_state, x, train=False, ranks=None):
            return drn_forward(params, bn_state, x, spec, train=train,
                               compute_dtype=compute_dtype, remat=remat,
                               sparse_plans=sparse_plans or None, ranks=ranks)

    return fwd


def make_cls_train_step(
    spec,
    tx: Sgd,
    compute_dtype=torch.bfloat16,
    teacher: tuple[Callable, Mapping, Mapping] | None = None,
    kd_student_wt: float = 0.5,
    kd_distill_wt: float = 0.5,
    kd_temperature: float = 4.0,
    remat: bool = False,
    sparse_plans: Mapping | None = None,
) -> Callable:
    """Classification train step with optional knowledge distillation
    (parity with rmbsnn_main.train, :432-500).  ``spec`` is a ``DrnSpec``
    (classifier naming) or a ``CifarSpec``.

    ``teacher`` is ``(forward_fn, params, bn_state)``, ``forward_fn`` mapping
    ``(params, bn_state, images) -> logits``; it runs in eval mode under
    ``torch.no_grad()``, and the loss is ``combined_kd_loss``.  Without a
    teacher the loss is the plain cross entropy.  ``remat`` and
    ``sparse_plans`` apply to the student (``classifier_forward``).
    Metrics: ``loss`` and the batch's top-1 ``acc`` (a fraction)."""
    fwd = classifier_forward(spec, compute_dtype, remat=remat, sparse_plans=sparse_plans)

    def train_step(state: TrainState, images, labels, ranks=None):
        dev = images.device
        with span("train.step"):
            params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
            with span("train.forward", device=dev):
                logits, bn_updates = fwd(params, state.bn_state, images, train=True,
                                         ranks=ranks)
                if teacher is not None:
                    t_fwd, t_params, t_bn = teacher
                    with torch.no_grad():
                        t_logits = t_fwd(t_params, t_bn, images)
                    loss = combined_kd_loss(logits, labels, t_logits, kd_student_wt,
                                            kd_distill_wt, kd_temperature, ranks=ranks)
                else:
                    loss = cross_entropy_ignore(logits, labels, ignore_index=-1, ranks=ranks)
            with span("train.backward", device=dev):
                grads = _grads(loss, params, state.params, ranks=ranks)
            with span("train.update", device=dev):
                new_params, new_opt = _sgd_update(tx, grads, state)
        new_state = TrainState(
            params=new_params,
            bn_state={**state.bn_state, **bn_updates},
            opt_state=new_opt,
            masks=state.masks,
            step=state.step + 1,
        )
        acc = (logits.detach().argmax(dim=-1) == labels).float().mean()
        if ranks is not None:
            acc = ranks.total(acc) / ranks.size  # equal parts: the global mean
        return new_state, {"loss": _total(loss.detach(), ranks), "acc": acc}

    return train_step


def make_eval_step(spec, kind: str = "seg", compute_dtype=torch.bfloat16):
    """Eval step returning the per-batch loss and predictions: DRNSeg's
    log-probs (``kind="seg"``) or a classifier's logits (``"cls"``)."""
    if kind == "seg":
        @torch.inference_mode()
        def eval_step(params, bn_state, images, labels):
            logp, _seg, _ = drnseg_forward(params, bn_state, images, spec, train=False,
                                           compute_dtype=compute_dtype)
            return seg_loss_from_logprobs(logp, labels), logp.argmax(dim=-1)

        return eval_step

    fwd = classifier_forward(spec, compute_dtype)

    @torch.inference_mode()
    def eval_step(params, bn_state, images, labels):
        logits, _ = fwd(params, bn_state, images, train=False)
        return cross_entropy_ignore(logits, labels, ignore_index=-1), logits.argmax(dim=-1)

    return eval_step
