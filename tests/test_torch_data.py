"""PyTorch port, data: the host-side STFT helpers, the synth,
synth-speech and wsj0 datasets (spectra and wave epochs), against the JAX
package on the CPU.  Every comparison is bit for bit: both packages run
the same numpy and scipy code on the same seeds.  Small sizes (SMPRATE
4000, two batches of three utterances)."""
import random

import numpy as np
import pytest

pytest.importorskip("torch")

from danet_tpu.data import audio as jaudio  # noqa: E402
from danet_tpu.data.synth import SyntheticTonesData as JaxSynth  # noqa
from danet_tpu.data.synth_speech import (  # noqa: E402
    SyntheticSpeechData as JaxSpeech)
from danet_tpu_torch.data import audio  # noqa: E402
from danet_tpu_torch.data.synth import SyntheticTonesData  # noqa: E402
from danet_tpu_torch.data.synth_speech import SyntheticSpeechData  # noqa
from danet_tpu_torch.data.wsj0 import Wsj0Dataset  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402

KEYS = dict(SMPRATE=4000, SYNTH_BATCHES=2, BATCH_SIZE=2)


def _hp_pair(fresh_hparams, **keys):
    keys = dict(KEYS, **keys)
    fresh_hparams.load(keys)
    fresh_hparams.digest()
    return load_config(**keys)


def _equal_epochs(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[0].dtype == y[0].dtype and x[0].shape == y[0].shape
        np.testing.assert_array_equal(x[0], y[0])


@pytest.mark.parametrize("cls,jcls", [(SyntheticTonesData, JaxSynth),
                                      (SyntheticSpeechData, JaxSpeech)])
@pytest.mark.parametrize("seed", [0, 5])
def test_torch_synth_epochs_match_jax(fresh_hparams, cls, jcls, seed):
    """epoch (complex spectra) and epoch_wave (float32 waveforms) of both
    synthetic corpora, train and valid, equal the JAX datasets' bit for
    bit, from the cache too; both declare the same WAVE_SCALE."""
    hp = _hp_pair(fresh_hparams)
    ds, jds = cls(hp, seed=seed), jcls(seed=seed)
    for d in (ds, jds):
        d.install_and_load()
    assert ds.WAVE_SCALE == jds.WAVE_SCALE
    assert ds.N_BATCHES == jds.N_BATCHES == 2
    for subset in ("train", "valid"):
        for _ in range(2):          # the second pass reads the cache
            _equal_epochs(ds.epoch(subset, 3), jds.epoch(subset, 3))
            _equal_epochs(ds.epoch_wave(subset, 3),
                          jds.epoch_wave(subset, 3))
    wave = next(iter(ds.epoch_wave("train", 3)))[0]
    assert wave.dtype == np.float32 and wave.shape == (3, 6000)


def test_torch_stft_helpers_match_jax(fresh_hparams):
    """stft_np, istft_np and spectra_to_wave at default.json's FFT keys
    equal the JAX package's (which read them from its hparams);
    spectra_to_wave inverts stft_np (re-STFT within 2e-2 of the peak,
    integer samples back to within 0.05)."""
    hp = _hp_pair(fresh_hparams)
    fft = (hp.FFT_SIZE, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
    rs = np.random.RandomState(0)
    wav = rs.randint(-20000, 20000, size=5000).astype(np.float64)
    spec = audio.stft_np(wav, *fft)
    np.testing.assert_array_equal(spec, jaudio.stft_np(wav))
    np.testing.assert_array_equal(audio.istft_np(spec, *fft[1:]),
                                  jaudio.istft_np(spec))
    back = audio.spectra_to_wave(spec, *fft)
    np.testing.assert_array_equal(back, jaudio.spectra_to_wave(spec))
    assert back.shape == ((spec.shape[0] - 1) * 64,)
    np.testing.assert_allclose(audio.stft_np(back.astype(np.float64), *fft),
                               spec, atol=2e-2 * np.abs(spec).max())
    n = min(len(back), len(wav))
    assert np.abs(back[:n] - wav[:n]).max() < 0.05


def test_torch_random_zeropad_matches_jax():
    """The pad split from random.Random(s) is JAX's split after
    random.seed(s); a zero pad draws nothing."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    rand = random.Random(3)
    random.seed(3)
    for pad in (5, 0, 7):
        np.testing.assert_array_equal(
            audio.random_zeropad(x, pad, -2, rand),
            jaudio.random_zeropad(x, pad, axis=-2))


def _write_wsj0_h5(path, lengths):
    """A wsj0-schema HDF5 file of integer-valued int16-scale utterances of
    the given sample lengths (so that batches need the random zero-pad),
    stored as their STFTs; train, valid and test split the rows."""
    import h5py
    hp = load_config()
    rs = np.random.RandomState(1)
    specs = [audio.stft_np(rs.randint(-20000, 20000, size=n).astype(
        np.float64), hp.FFT_SIZE, hp.FFT_STRIDE, hp.FFT_WND_ARRAY)
        for n in lengths]
    n = len(specs)
    with h5py.File(path, "w") as f:
        dt = h5py.special_dtype(vlen=np.dtype("complex64"))
        feats = f.create_dataset("features", (n,), dtype=dt)
        shapes = f.create_dataset("features_shapes", (n, 2), dtype="int32")
        for i, s in enumerate(specs):
            feats[i] = s.reshape(-1)
            shapes[i] = s.shape
        split_dt = np.dtype([("split", "S8"), ("source", "S16"),
                             ("start", "int64"), ("stop", "int64")])
        f.attrs["split"] = np.asarray(
            [(b"train", b"features", 0, n - 2),
             (b"valid", b"features", n - 2, n),
             (b"test", b"features", n - 2, n)], dtype=split_dt)
    return specs


LENGTHS = [2000, 1500, 2300, 1800, 2100, 1000, 1700, 2200, 1200]


@pytest.mark.parametrize("shuffle", [True, False])
def test_torch_wsj0_epochs_match_jax(fresh_hparams, tmp_path, shuffle):
    """wsj0's epoch and epoch_wave on a written HDF5 fixture equal the JAX
    dataset's bit for bit: the shuffle from RandomState(s) is JAX's
    np.random.shuffle after np.random.seed(s), the pad split from
    random.Random(r) JAX's after random.seed(r); the row order is the
    requested one; the wave cache serves the same arrays."""
    pytest.importorskip("h5py")
    from danet_tpu.data.wsj0 import Wsj0Dataset as JaxWsj0
    hp = _hp_pair(fresh_hparams)
    path = str(tmp_path / "wsj0-danet.hdf5")
    _write_wsj0_h5(path, LENGTHS)
    ds, jds = Wsj0Dataset(hp, path=path), JaxWsj0(path=path)
    for d in (ds, jds):
        d.install_and_load()
    assert ds.WAVE_SCALE == jds.WAVE_SCALE == 32768.0
    for name in ("epoch", "epoch_wave"):
        for subset in ("train", "valid"):
            for _ in range(2):
                np.random.seed(11)
                random.seed(12)
                ref = list(getattr(jds, name)(subset, 3, shuffle=shuffle))
                out = getattr(ds, name)(
                    subset, 3, shuffle=shuffle,
                    rng=np.random.RandomState(11), rand=random.Random(12))
                _equal_epochs(out, ref)
    assert len(ref) == 1    # valid: 2 rows wrapped to one batch of 3


def test_torch_wsj0_path_and_missing_file(fresh_hparams, tmp_path):
    """WSJ0_PATH comes from the config; a missing file raises IOError."""
    hp = load_config(WSJ0_PATH=str(tmp_path / "none.hdf5"))
    ds = Wsj0Dataset(hp)
    assert ds.path == str(tmp_path / "none.hdf5")
    with pytest.raises(IOError):
        ds.install_and_load()
    with pytest.raises(RuntimeError):
        next(ds.epoch("train", 2))
