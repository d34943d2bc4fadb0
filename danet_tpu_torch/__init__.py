"""danet_tpu_torch: the PyTorch / CUDA port of danet_tpu for NVIDIA Hopper.

It imports torch, numpy and scipy, and never jax or danet_tpu: the machine
that runs it on the GPU has no jax.  The component registries (encoders,
estimators, separators, models, optimizers, datasets) fill at their first
lookup (``hparams._register_all``), so that importing the package, or a
serving bundle's loader (``danet_tpu_torch.serve``), loads no model code.
The CUDA kernels build at first use (ops/cuda/_build.py), so the import
also works where there is no nvcc.
"""
__version__ = "0.1.0"
