"""The repo's tools on the port (port of ``tools/``): ``train_supervisor``
(relaunches ``python -m maggie_tpu_torch.main`` after a failure, resuming
from ``last_state.pt``) and ``gen_mask`` (M-HIM2K guidance masks from the
instance alphas). Each runs as ``python -m maggie_tpu_torch.tools.<name>``."""
