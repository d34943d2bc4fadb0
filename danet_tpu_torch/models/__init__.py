from danet_tpu_torch.models.base import (  # noqa: F401
    Encoder, Estimator, ModelModule, Separator)
import danet_tpu_torch.models.encoders  # noqa: F401
import danet_tpu_torch.models.estimators  # noqa: F401
import danet_tpu_torch.models.separators  # noqa: F401
from danet_tpu_torch.models.danet import DaNet  # noqa: F401
from danet_tpu_torch.models.tasnet import TasNet  # noqa: F401
