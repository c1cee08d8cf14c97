"""tpuseg_torch — the PyTorch / CUDA port of ``tpuseg`` for one NVIDIA H100.

``tpuseg`` (JAX, TPU) stays the reference; this package mirrors its module
paths and names so every function has an obvious counterpart:

- ``tpuseg_torch.models``  — DRN backbone + DRNSeg head (inference forward),
  sparse execution plans (``models.sparse_exec``)
- ``tpuseg_torch.ops``     — BN folding, polyphase frontend, fused x8
  upsample+argmax, the block-sparse convs and BSR matmuls (hand-written
  CUDA kernels under ``csrc/``), gathered and RBGP sparse lowerings
- ``tpuseg_torch.sparsity`` — pruning masks from JSON pruner configs (the
  port's copy of ``tpuseg``'s maskers)
- ``tpuseg_torch.video``   — batched video segmentation serving
- ``tpuseg_torch.cli``     — ``python -m tpuseg_torch.cli.seg_video``
- ``tpuseg_torch.bench_sparse`` — the sparse-conv lowerings timed per conv
  on the card
- ``tpuseg_torch.train``   — segmentation training (``cli.semantic_seg``)
- ``tpuseg_torch.tools``   — the trained-weights fidelity harness
  (``tools.trained_fidelity``) and ``tools.remat_mem``

Conventions: public functions keep ``tpuseg``'s layouts (flat ``(B, H, W*3)``
uint8 frames, ``(N, h, w, C)`` logits, ``(N, H, W)`` uint8 ids); convs run
inside on NCHW-shaped tensors in ``torch.channels_last`` memory, so the
permutes at the edges are views.  Weights are a flat ``{torch-name: tensor}``
dict with conv weights in OIHW.  Every device is passed explicitly.

The package imports ``torch`` and never ``jax``, and nothing of ``tpuseg``:
what it needs of a numpy-only ``tpuseg`` module (the maskers) it keeps as
its own copy.
"""

__version__ = "0.1.0"
