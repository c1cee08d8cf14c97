"""Research tools of the port (counterparts of ``tpuseg/tools/``):
``python -m tpuseg_torch.tools.trained_fidelity`` (the trained-weights
fidelity report), ``python -m tpuseg_torch.tools.remat_mem`` (the
``--remat`` memory of one train step on the card), ``spectral`` (the
spectral gap of a mask's bipartite graph), ``stats`` (per-layer sparsity
and GEMM shapes), ``python -m tpuseg_torch.tools.visualize`` (mask images
of a checkpoint), ``python -m tpuseg_torch.tools.gen_configs`` (the
``optimal_configs/`` set) and ``python -m tpuseg_torch.tools.imagenet_prep``
(ImageNet directory layout)."""
from tpuseg_torch.tools.spectral import (  # noqa: F401
    calculate_spectral_gap,
    kronecker_eigen_check,
    mask_bipartite_adjacency,
)
from tpuseg_torch.tools.stats import get_matrix_shapes, get_sparsity_stats  # noqa: F401
