"""danet_tpu_torch: the PyTorch / CUDA port of danet_tpu for NVIDIA Hopper.

Importing this package populates the port's own component registries
(encoders, estimators, separators, models, optimizers, datasets).  It
imports torch, numpy and scipy, and never jax or danet_tpu: the machine
that runs it on the GPU has no jax.  The CUDA kernels build at first use (ops/cuda/_build.py), so the
import also works where there is no nvcc.
"""
from danet_tpu_torch.hparams import hparams  # noqa: F401
import danet_tpu_torch.models  # noqa: F401
import danet_tpu_torch.optim  # noqa: F401
import danet_tpu_torch.data.dataset  # noqa: F401
import danet_tpu_torch.data.synth  # noqa: F401
import danet_tpu_torch.data.synth_speech  # noqa: F401
import danet_tpu_torch.data.wsj0  # noqa: F401
import danet_tpu_torch.data.wavdir  # noqa: F401
import danet_tpu_torch.data.timit  # noqa: F401

__version__ = "0.1.0"
