from buffalo_tpu_torch.parallel.base import (ParALS, ParBPRMF,  # noqa: F401
                                             ParCFR, ParEALS, Parallel,
                                             ParW2V)
from buffalo_tpu_torch.parallel.ann import IVFIndex  # noqa: F401
