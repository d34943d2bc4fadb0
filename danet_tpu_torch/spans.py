"""Named spans of the port's stages, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records, and one shared null context otherwise: an unguarded
``record_function`` costs about 10 µs on a host CPU with no profiler
running, the check about 0.1 µs.  The spans are the profiler's user
annotations, so they land in the same Chrome trace as the card's
activity, on its clock; under ``torch.autograd.profiler.emit_nvtx`` they
are NVTX ranges.  Every name starts with ``danet.``:

  serving (``serve.py::Separator.separate``, ``models/danet.py``):
    danet.request     one ``Separator.separate`` call, ending in the copy
                      to the host
    danet.upload      the waveform onto the device
    danet.stft        kernel A (or the plain STFT)
    danet.features    magnitudes, log-magnitudes, the phase
    danet.encoder     the encoder (also in training and validation)
    danet.estimator   the attractors (also in training and validation)
    danet.masks       the separator and the phase product (also in
                      training: the separator)
    danet.istft       the inverse STFT
    danet.download    the trim and the copy to the host

  training (``train/trainer.py``):
    danet.train.feed_wait      the main thread's wait for a prepared batch
    danet.train.wire_cast      the wire cast into a pinned buffer (on the
                               prefetch thread in the epoch loop)
    danet.train.put            the batch's copy onto the device
    danet.train.call           ``train_steps``: K steps on one stack
    danet.train.replay         the K-step CUDA graph's replay
    danet.train.capture        a K-step graph's capture, with its warm-up
    danet.train.step           one eager step (``train_step``)
    danet.train.metrics_fetch  the epoch loop's fetch of pending metrics
    danet.loss                 the PIT loss and its auxiliaries
    danet.backward             the gradient
    danet.optimizer            the clip and the update

A K-step graph records its model spans once, at its capture; a replay
shows ``danet.train.replay`` alone.
"""
from __future__ import annotations

import contextlib
import types

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
# the process's flag (set by torch.profiler, the autograd profiler and
# emit_nvtx while one runs), on a PyTorch that keeps it
_PROCESS = (_autograd_profiler
            if hasattr(_autograd_profiler, "_is_profiler_enabled")
            else types.SimpleNamespace(_is_profiler_enabled=False))
_this_thread = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager that names its body ``name`` in a profiler's
    trace; the shared null context when no profiler is on, neither one of
    the process's (which records other threads too when it profiles them
    all) nor this thread's."""
    if _PROCESS._is_profiler_enabled or _this_thread():
        return torch.profiler.record_function(name)
    return _OFF
