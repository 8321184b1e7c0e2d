"""Algorithm drivers (reference buffalo/algo/ analog)."""
from buffalo_tpu_torch.models.als import ALS  # noqa: F401
from buffalo_tpu_torch.models.bpr import BPRMF  # noqa: F401
from buffalo_tpu_torch.models.options import (ALSOption, AlgoOption,  # noqa: F401
                                              BPRMFOption)
