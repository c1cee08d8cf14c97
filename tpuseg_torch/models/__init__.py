"""DRN backbones and the DRNSeg head (inference), with ``tpuseg``'s names."""
from tpuseg_torch.models.drn import (  # noqa: F401
    DRN_ARCHS,
    DrnSpec,
    build_drn_spec,
    drn_forward,
    init_drn,
)
from tpuseg_torch.models.drnseg import (  # noqa: F401
    bilinear_upsample_kernel,
    drnseg_forward,
    drnseg_logits,
    init_drnseg,
)
from tpuseg_torch.models.weights import from_jax_params, to_jax_params  # noqa: F401
