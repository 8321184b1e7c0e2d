from buffalo_tpu_torch.evaluate.base import Evaluable  # noqa: F401
