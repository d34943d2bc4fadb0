"""WSJ0 dataset: HDF5-backed variable-length STFT spectra.

Counterpart of ``danet_tpu/data/wsj0.py``.  It reads ``wsj0-danet.hdf5``
(a ``features`` dataset of flattened variable-length complex spectra, the
per-example shapes, and a ``split`` attribute of (split, source, start,
stop) rows; either the single ``features`` source or one
``{split}_spectra`` source per subset).  An epoch wraps the row indices
modulo the subset's size so that every batch is full, shuffles them with
the epoch's ``RandomState`` (JAX: ``np.random.shuffle`` on the global
stream that the trainer seeds with the same key), fetches the rows in the
requested order, and zero-pads each batch to its longest utterance with a
random left/right split drawn from ``rand``.  ``epoch_wave`` inverts each
stored STFT once (``Dataset._wave_from_spectra``) and caches it.  h5py is
imported when the data are loaded, so that the package imports without
it.
"""
from __future__ import annotations

import os

import numpy as np

from danet_tpu_torch.data.audio import random_zeropad
from danet_tpu_torch.data.dataset import Dataset
from danet_tpu_torch.hparams import hparams


@hparams.register_dataset("wsj0")
class Wsj0Dataset(Dataset):
    # the stored spectra are STFTs of raw 16-bit PCM samples, so the
    # inverted waveforms come back at int16 scale: WAVE_PCM_SCALE=32768
    WAVE_SCALE = 32768.0

    def __init__(self, hp=None, seed: int = 0, path: str = None):
        super().__init__(hp, seed)
        self.path = path or getattr(self.hp, "WSJ0_PATH", "") \
            or os.path.join(os.path.dirname(__file__), "WSJ0",
                            "wsj0-danet.hdf5")

    def __del__(self):
        if getattr(self, "is_loaded", False):
            try:
                self.h5file.close()
            except Exception:
                pass  # interpreter teardown: h5py internals may be gone

    def install_and_load(self):
        try:
            import h5py
        except ImportError:
            raise RuntimeError("h5py is required for the WSJ0 dataset")
        if not os.path.exists(self.path):
            raise IOError('Did not find WSJ0 file "%s"' % self.path)
        self.h5file = h5py.File(self.path, "r")
        self.splits = {}
        for row in self.h5file.attrs["split"]:
            name = row["split"] if isinstance(row["split"], str) \
                else row["split"].decode()
            source = row["source"] if isinstance(row["source"], str) \
                else row["source"].decode()
            self.splits.setdefault(
                name, (source, int(row["start"]), int(row["stop"])))
        self.is_loaded = True

    def _fetch(self, subset: str, rows: np.ndarray):
        source, start, _ = self.splits[subset]
        feats = self.h5file[source]
        shapes = self.h5file[source + "_shapes"] \
            if source + "_shapes" in self.h5file \
            else self.h5file["features_shapes"]
        # the requested order: the HDF5 rows are per speaker, so a sorted
        # fetch would undo the shuffle and mix a speaker with itself
        out = []
        for r in rows:
            t, f = shapes[start + r]
            out.append(feats[start + r].reshape(t, f))
        return out

    def _epoch_rows(self, subset, batch_size, shuffle, rng):
        _, start, stop = self.splits[subset]
        size = stop - start
        n_pad = ((size + batch_size - 1) // batch_size) * batch_size
        indices = np.arange(n_pad) % size
        if shuffle:
            (rng if rng is not None else self.rng).shuffle(indices)
        for i in range(0, n_pad, batch_size):
            yield indices[i:i + batch_size]

    def epoch(self, subset, batch_size, shuffle=False, rng=None, rand=None):
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        rand = rand if rand is not None else self.rand
        for batch_rows in self._epoch_rows(subset, batch_size, shuffle, rng):
            spectra_li = self._fetch(subset, batch_rows)
            max_len = max(len(x) for x in spectra_li)
            yield (np.stack([
                random_zeropad(x, max_len - len(x), -2, rand)
                for x in spectra_li]),)

    def epoch_wave(self, subset, batch_size, shuffle=False, rng=None,
                   rand=None):
        """[batch, S] float32 waveforms, each the exact inverse of its
        stored STFT."""
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        rand = rand if rand is not None else self.rand
        for batch_rows in self._epoch_rows(subset, batch_size, shuffle, rng):
            spectra_li = self._fetch(subset, batch_rows)
            waves = [self._wave_from_spectra((subset, int(r)), x)
                     for r, x in zip(batch_rows, spectra_li)]
            max_len = max(len(w) for w in waves)
            yield (np.stack([
                random_zeropad(w, max_len - len(w), -1, rand)
                for w in waves]),)
