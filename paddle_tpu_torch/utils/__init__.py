from paddle_tpu_torch.utils import unique_name  # noqa: F401
from paddle_tpu_torch.utils.enforce import EnforceError, enforce  # noqa: F401
