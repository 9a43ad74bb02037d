"""The repo's tools on the port (port of ``tools/``): ``train_supervisor``
(relaunches ``python -m maggie_tpu_torch.main`` after a failure, resuming
from ``last_state.pt``), ``gen_mask`` (M-HIM2K guidance masks from the
instance alphas), and the block-capacity studies ``cap_quality``,
``train_curve`` and ``train_long``. Each runs as ``python -m
maggie_tpu_torch.tools.<name>``."""
