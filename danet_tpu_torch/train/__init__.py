"""Training of the port: ``trainer.Trainer`` and the ``python -m
danet_tpu_torch.train`` CLI."""
from danet_tpu_torch.train.trainer import Trainer, prepare_batch  # noqa: F401
