from buffalo_tpu_torch.parallel.base import ParALS, ParBPRMF, Parallel  # noqa: F401
from buffalo_tpu_torch.parallel.ann import IVFIndex  # noqa: F401
