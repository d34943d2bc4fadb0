"""A folder of WAV files as a dataset ('wav-dir'), with no offline step.

Counterpart of ``danet_tpu/data/wavdir.py``.  ``WAVDIR_PATH`` (or the
``path`` argument) names either a folder with ``train/``, ``valid/`` and
``test/`` subfolders of ``*.wav`` files, used as they are (a missing
``valid/`` takes ``test/``'s files and the other way round, then
``train/``'s; a missing ``train/`` raises), or one flat folder, whose files
split 8/1/1 into train, valid and test by the CRC32 of their names (the
same split on every host and run).  An eval split that falls back to the
training files says so on stdout.  Each split is sorted by file size (a
proxy of the duration), so that a batch pads little.

``epoch`` yields [batch, T, F] complex64 spectra (``audio.load_wavfile``:
mono, resampled to SMPRATE, the samples as the file stores them, STFT);
``epoch_wave`` yields [batch, S] float32 waveforms of the same samples, so
that the spectra wire and the wave wire are interchangeable on one
checkpoint.  The int16 wave wire refuses a file that is not 16-bit PCM.
Both pad each batch to its longest utterance with a random left/right
split drawn from ``rand``, shuffle with ``rng``, and keep what they load
in one cache of at most WAVDIR_CACHE_MB megabytes.  A subset smaller than
a batch repeats its files to fill one batch; the last partial batch is
the subset's last ``batch_size`` files.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from danet_tpu_torch.data.audio import (load_wav_raw, load_wavfile,
                                        random_zeropad)
from danet_tpu_torch.data.dataset import Dataset
from danet_tpu_torch.hparams import hparams


@hparams.register_dataset("wav-dir")
class WavDirDataset(Dataset):
    SUBSETS = ("train", "valid", "test")
    # the waves keep the files' own sample scale: the int16 wire's
    # WAVE_PCM_SCALE is 16-bit PCM's bound
    WAVE_SCALE = 32768.0

    def __init__(self, hp=None, seed: int = 0, path: str = None):
        super().__init__(hp, seed)
        self.path = path
        self._cache: dict = {}
        self._cache_bytes = 0

    def _root(self) -> str:
        root = self.path or getattr(self.hp, "WAVDIR_PATH", "") or ""
        if not root:
            raise IOError(
                "the wav-dir dataset needs WAVDIR_PATH (a folder of WAVs, "
                "or one with train/valid/test subfolders): set it in the "
                "config or pass WavDirDataset(path=...)")
        if not os.path.isdir(root):
            raise IOError("WAVDIR_PATH %r is not a directory" % root)
        return root

    @staticmethod
    def _list_wavs(d: str) -> list:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return []
        return [os.path.join(d, n) for n in names
                if n.lower().endswith(".wav")]

    def install_and_load(self):
        root = self._root()
        sub_lists = {s: self._list_wavs(os.path.join(root, s))
                     for s in self.SUBSETS}
        if any(sub_lists.values()):
            files = sub_lists
            # no train/ split is an error: training on the eval files
            # unasked would be wrong
            if not files["train"]:
                raise IOError(
                    "no .wav files under %s (the subfolder layout needs "
                    "a train/ split)" % os.path.join(root, "train"))
        else:
            flat = self._list_wavs(root)
            if not flat:
                raise IOError("no .wav files under %r" % root)
            files = {s: [] for s in self.SUBSETS}
            for p in flat:
                h = zlib.crc32(os.path.basename(p).encode()) % 10
                files["train" if h < 8 else
                      "valid" if h == 8 else "test"].append(p)
        for a, b in (("valid", "test"), ("test", "valid")):
            if not files[a]:
                files[a] = files[b] or files["train"]
        for s in ("valid", "test"):
            if files[s] is files["train"]:
                print("[WARNING] wav-dir %r split is empty and aliases the "
                      "TRAINING files — eval metrics will be optimistic; "
                      "add real %s data for trustworthy validation"
                      % (s, s))
        self.files = {s: sorted(files[s], key=lambda p: (os.path.getsize(p),
                                                          p))
                      for s in self.SUBSETS}
        self.is_loaded = True

    def _cached(self, key, make) -> np.ndarray:
        """``make()``, kept while the cache holds at most WAVDIR_CACHE_MB
        megabytes."""
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        arr = make()
        cap = float(getattr(self.hp, "WAVDIR_CACHE_MB", 2048) or 0)
        if self._cache_bytes + arr.nbytes <= cap * 1e6:
            self._cache[key] = arr
            self._cache_bytes += arr.nbytes
        return arr

    def _spectra(self, path: str) -> np.ndarray:
        hp = self.hp
        return self._cached(path, lambda: load_wavfile(
            path, hp.SMPRATE, hp.FFT_SIZE, hp.FFT_STRIDE,
            hp.FFT_WND_ARRAY).astype(np.complex64))

    def _wave(self, path: str) -> np.ndarray:
        hp = self.hp

        def make():
            wav, dtype = load_wav_raw(path, hp.SMPRATE, normalize=False,
                                      with_dtype=True)
            if (dtype != np.int16 and str(getattr(
                    hp, "TRANSFER_DTYPE", "float32")) == "int16"):
                raise ValueError(
                    "TRANSFER_DTYPE='int16' wave wire: %r holds %s "
                    "samples — the symmetric 32768 PCM quantization is "
                    "only exact/well-scaled for 16-bit PCM sources. Use "
                    "TRANSFER_DTYPE='bfloat16'/'float32' or convert the "
                    "corpus to 16-bit WAVs." % (path, np.dtype(dtype).name))
            return wav

        return self._cached(("wave", path), make)

    def _epoch_impl(self, subset, batch_size, shuffle, rng, rand, load,
                    pad_axis):
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        if subset not in self.files:
            raise KeyError('Unknown subset "%s", valid options are %s'
                           % (subset, list(self.files)))
        rng = rng if rng is not None else self.rng
        rand = rand if rand is not None else self.rand
        files = self.files[subset]
        tot = len(files)
        idx = rng.permutation(tot) if shuffle else np.arange(tot)
        if 0 < tot < batch_size:
            idx = np.resize(idx, batch_size)
            tot = batch_size

        def make_batch(sel):
            sigs = [load(files[j]) for j in sel]
            max_len = max(len(s) for s in sigs)
            return (np.stack([random_zeropad(s, max_len - len(s), pad_axis,
                                             rand) for s in sigs]),)

        for i in range(0, tot - batch_size + 1, batch_size):
            yield make_batch(idx[i:i + batch_size])
        if tot >= batch_size and tot % batch_size:
            yield make_batch(idx[-batch_size:])

    def epoch(self, subset, batch_size, shuffle=False, rng=None, rand=None):
        yield from self._epoch_impl(subset, batch_size, shuffle, rng, rand,
                                    self._spectra, -2)

    def epoch_wave(self, subset, batch_size, shuffle=False, rng=None,
                   rand=None):
        """[batch, S] float32 waveforms at the files' own sample scale."""
        yield from self._epoch_impl(subset, batch_size, shuffle, rng, rand,
                                    self._wave, -1)
