"""Algorithm drivers (reference buffalo/algo/ analog)."""
from buffalo_tpu_torch.models.als import ALS  # noqa: F401
from buffalo_tpu_torch.models.bpr import BPRMF  # noqa: F401
from buffalo_tpu_torch.models.cfr import CFR  # noqa: F401
from buffalo_tpu_torch.models.eals import EALS  # noqa: F401
from buffalo_tpu_torch.models.options import (ALSOption, AlgoOption,  # noqa: F401
                                              BPRMFOption, CFROption,
                                              EALSOption, PLSIOption,
                                              W2VOption, WARPOption)
from buffalo_tpu_torch.models.plsi import PLSI  # noqa: F401
from buffalo_tpu_torch.models.w2v import W2V  # noqa: F401
from buffalo_tpu_torch.models.warp import WARP  # noqa: F401
