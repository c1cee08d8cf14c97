"""Research tools of the port (counterparts of ``tpuseg/tools/``):
``python -m tpuseg_torch.tools.trained_fidelity`` (the trained-weights
fidelity report), ``python -m tpuseg_torch.tools.remat_mem`` (the
``--remat`` memory of one train step on the card) and ``spectral`` (the
spectral gap of a mask's bipartite graph)."""
from tpuseg_torch.tools.spectral import (  # noqa: F401
    calculate_spectral_gap,
    kronecker_eigen_check,
    mask_bipartite_adjacency,
)
