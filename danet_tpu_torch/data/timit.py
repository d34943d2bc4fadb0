"""TIMIT dataset: pickled STFT spectra with their transcripts.

Counterpart of ``danet_tpu/data/timit.py``.  It loads
``<TIMIT_DIR>/{train,test}_set.pkl``, each three pickled lists (spectra
[T, F] complex64, phonemes, texts as int32 codes), as the JAX package's
offline ``data/TIMIT/process.py`` writes them (not ported; the port reads
its output); ``valid`` is ``test``.  ``epoch`` shuffles the utterances
with ``rng``, pads each batch to its longest one with a random left/right
split drawn from ``rand``, and yields (spectra, (t_idx, t_val, t_shape)),
the texts as a sparse tensor's indices, values and shape (the training
loop reads only the spectra).  The last full batch is kept when the
subset's size is a multiple of the batch, and a remainder batch is the
subset's last ``batch_size`` utterances.  ``epoch_wave`` inverts each
stored STFT once (``Dataset._wave_from_spectra``) for the wave wire: the
spectra are STFTs of 16-bit PCM samples, so WAVE_SCALE is 32768.
"""
from __future__ import annotations

import gc
import os
import pickle
import string

import numpy as np

from danet_tpu_torch.data.audio import random_zeropad
from danet_tpu_torch.data.dataset import Dataset
from danet_tpu_torch.hparams import hparams


@hparams.register_dataset("timit")
class TimitDataset(Dataset):
    CHARSET = string.ascii_lowercase + " "
    # '$' at index 0 ends a stream: the table the pickles were encoded with
    PHONEME_LI = (
        "$_aa_ae_ah_ao_aw_ax_ax-h_axr_ay_b_bcl_ch_d_dcl_dh_"
        "dx_eh_el_em_en_eng_epi_er_ey_f_g_gcl_h#_hh_hv_ih_"
        "ix_iy_jh_k_kcl_l_m_n_ng_nx_ow_oy_p_pau_pcl_q_r_"
        "s_sh_t_tcl_th_uh_uw_ux_v_w_y_z_zh").split("_")
    PHONEME_DI = {v: k for k, v in enumerate(PHONEME_LI)}
    WORD_DI = {v: k for k, v in enumerate(CHARSET)}
    WAVE_SCALE = 32768.0

    def __init__(self, hp=None, seed: int = 0, data_dir: str = None):
        super().__init__(hp, seed)
        self.data_dir = data_dir or getattr(self.hp, "TIMIT_DIR", "") \
            or os.path.join(os.path.dirname(__file__), "TIMIT")

    def install_and_load(self):
        self.subset = {}
        for subset in ("train", "test"):
            path = os.path.join(self.data_dir, "%s_set.pkl" % subset)
            if not os.path.exists(path):
                raise IOError(
                    'Did not find TIMIT file "%s": set TIMIT_DIR to the '
                    "folder of the pickles that the JAX package's "
                    "data/TIMIT/process.py writes" % path)
            with open(path, "rb") as f:
                gc.disable()        # many small objects: a faster unpickle
                try:
                    self.subset[subset] = [pickle.load(f) for _ in range(3)]
                finally:
                    gc.enable()
        self.subset["valid"] = self.subset["test"]
        self.is_loaded = True

    def _order(self, subset, batch_size, shuffle, rng):
        """The epoch's batches of utterance indices."""
        if not self.is_loaded:
            raise RuntimeError("Dataset is not loaded.")
        if subset not in self.subset:
            raise KeyError('Unknown subset "%s", valid options are %s'
                           % (subset, list(self.subset)))
        tot = len(self.subset[subset][0])
        rng = rng if rng is not None else self.rng
        idx = rng.permutation(tot) if shuffle else np.arange(tot)
        for i in range(0, tot - batch_size + 1, batch_size):
            yield idx[i:i + batch_size]
        if tot >= batch_size and tot % batch_size:
            yield idx[-batch_size:]

    def epoch(self, subset, batch_size, shuffle=False, rng=None, rand=None):
        rand = rand if rand is not None else self.rand
        for sel in self._order(subset, batch_size, shuffle, rng):
            signals_li, _, texts_li = self.subset[subset]
            sigs = [signals_li[j] for j in sel]
            txts = [texts_li[j] for j in sel]
            max_len = max(len(s) for s in sigs)
            batch = np.stack([random_zeropad(s, max_len - len(s), -2, rand)
                              for s in sigs])
            n_chars = sum(len(t) for t in txts)
            t_idx = np.empty((n_chars, 2), dtype=np.int32)
            t_val = (np.concatenate(txts) if n_chars
                     else np.zeros((0,), dtype=np.int32))
            pos = 0
            for j, t in enumerate(txts):
                t_idx[pos:pos + len(t), 0] = j
                t_idx[pos:pos + len(t), 1] = np.arange(len(t))
                pos += len(t)
            t_shape = (len(sel), max((len(t) for t in txts), default=0))
            yield batch, (t_idx, t_val, t_shape)

    def epoch_wave(self, subset, batch_size, shuffle=False, rng=None,
                   rand=None):
        """[batch, S] float32 waveforms, each the exact inverse of its
        stored STFT; no text aux."""
        rand = rand if rand is not None else self.rand
        for sel in self._order(subset, batch_size, shuffle, rng):
            signals_li = self.subset[subset][0]
            waves = [self._wave_from_spectra((subset, int(j)),
                                             signals_li[j]) for j in sel]
            max_len = max(len(w) for w in waves)
            yield (np.stack([random_zeropad(w, max_len - len(w), -1, rand)
                             for w in waves]),)

    @classmethod
    def encode_from_str(cls, s):
        return np.asarray([cls.WORD_DI[c] for c in s], dtype=np.int32)

    @classmethod
    def decode_to_str(cls, arr):
        charset = cls.CHARSET + "$"
        return "".join(charset[i] for i in arr).strip(" $")
