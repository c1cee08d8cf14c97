"""Meters, segmentation metrics and run logs for the port."""
from tpuseg_torch.metrics.meters import AverageMeter, FpsMeter, ProgressMeter  # noqa: F401
from tpuseg_torch.metrics.seg import (  # noqa: F401
    fast_hist,
    miou_from_hist,
    per_class_iu,
    pixel_accuracy,
    top_k_accuracy,
)
