from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.layers.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.layers.pipeline import *  # noqa: F401,F403
from paddle_tpu_torch.layers import learning_rate_scheduler  # noqa: F401
from paddle_tpu_torch.layers import collective  # noqa: F401
