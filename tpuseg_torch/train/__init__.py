"""Training for the port (counterpart of ``tpuseg.train``):
losses, SGD and schedules, train/eval steps, npz checkpoints, rejig and
unstructured masks."""
from tpuseg_torch.train.loss import (  # noqa: F401
    combined_kd_loss,
    cross_entropy_ignore,
    kd_loss,
    seg_loss_from_logprobs,
)
from tpuseg_torch.train.optim import (  # noqa: F401
    make_sgd,
    milestones_for_epochs,
    multistep_schedule,
    poly_schedule,
)
from tpuseg_torch.train.trainer import (  # noqa: F401
    TrainState,
    classifier_forward,
    create_train_state,
    make_cls_train_step,
    make_eval_step,
    make_seg_train_step,
)
from tpuseg_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from tpuseg_torch.train.rejig import sparsity_aware_reinit  # noqa: F401
from tpuseg_torch.train.unstructured import magnitude_unstructured_masks  # noqa: F401
