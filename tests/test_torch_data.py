"""PyTorch port, data: the host-side STFT helpers and WAV loaders, the
synth, synth-speech, wsj0, wav-dir and timit datasets (spectra and wave
epochs), against the JAX package on the CPU.  Every comparison is bit for
bit: both packages run the same numpy and scipy code on the same seeds.
Small sizes (SMPRATE 4000, batches of three or four utterances)."""
import os
import random

import numpy as np
import pytest
import scipy.io.wavfile

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


# ------------------------------------------------------------------ wav-dir
def _write_wavs(folder, n, rs, base=1500, step=97, dtype=np.int16,
                rate=8000):
    """``n`` WAVs of growing lengths (so that batches pad) at ``rate``:
    int16 PCM, or float32 samples near +/-0.1."""
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        x = rs.randn(base + step * i)
        x = (x * 3000).astype(np.int16) if dtype == np.int16 \
            else (x * 0.1).astype(np.float32)
        scipy.io.wavfile.write(str(folder / ("u%02d.wav" % i)), rate, x)


def _equal_epoch_pair(ds, jds, names=("epoch", "epoch_wave"),
                      subsets=("train", "valid", "test"), batch=3,
                      shuffle=True):
    """Each epoch of ``ds`` and ``jds`` equal bit for bit, the port's draws
    from RandomState(11) and Random(12), JAX's after np.random.seed(11)
    and random.seed(12); the second pass reads the caches."""
    for name in names:
        for subset in subsets:
            for _ in range(2):
                np.random.seed(11)
                random.seed(12)
                ref = list(getattr(jds, name)(subset, batch,
                                              shuffle=shuffle))
                out = getattr(ds, name)(subset, batch, shuffle=shuffle,
                                        rng=np.random.RandomState(11),
                                        rand=random.Random(12))
                _equal_epochs(out, ref)


@pytest.mark.parametrize("shuffle", [True, False])
def test_torch_wavdir_flat_split_matches_jax(fresh_hparams, tmp_path,
                                             shuffle):
    """A flat folder of int16 WAVs at 8 kHz (resampled to SMPRATE 4000):
    the CRC split and the length sort equal JAX's, and every epoch (spectra
    and waves, train, valid and test) equals JAX's bit for bit; the waves
    keep the files' int16 scale (WAVE_SCALE 32768)."""
    from danet_tpu.data.wavdir import WavDirDataset as JaxWavDir
    from danet_tpu_torch.data.wavdir import WavDirDataset
    hp = _hp_pair(fresh_hparams)
    _write_wavs(tmp_path / "flat", 24, np.random.RandomState(1))
    ds = WavDirDataset(hp, path=str(tmp_path / "flat"))
    jds = JaxWavDir(path=str(tmp_path / "flat"))
    for d in (ds, jds):
        d.install_and_load()
    assert ds.files == jds.files
    assert len(ds.files["train"]) >= 16 and ds.WAVE_SCALE == 32768.0
    _equal_epoch_pair(ds, jds, shuffle=shuffle)
    wave = next(iter(ds.epoch_wave("train", 3)))[0]
    assert wave.dtype == np.float32 and np.abs(wave).max() > 1000


def test_torch_wavdir_subfolders_match_jax(fresh_hparams, tmp_path,
                                           capsys):
    """The train/ and test/ layout (valid/ missing: it takes test/'s
    files) equals JAX's; a 2-file test split fills a batch of 3 by
    repeating; a layout without eval splits says loudly that they alias
    the training files."""
    from danet_tpu.data.wavdir import WavDirDataset as JaxWavDir
    from danet_tpu_torch.data.wavdir import WavDirDataset
    hp = _hp_pair(fresh_hparams)
    rs = np.random.RandomState(2)
    _write_wavs(tmp_path / "sub" / "train", 7, rs)
    _write_wavs(tmp_path / "sub" / "test", 2, rs, base=1800)
    ds = WavDirDataset(hp, path=str(tmp_path / "sub"))
    jds = JaxWavDir(path=str(tmp_path / "sub"))
    for d in (ds, jds):
        d.install_and_load()
    assert ds.files == jds.files and ds.files["valid"] == ds.files["test"]
    _equal_epoch_pair(ds, jds)
    assert len(list(ds.epoch("test", 3))) == 1
    capsys.readouterr()
    _write_wavs(tmp_path / "trainonly" / "train", 3, rs)
    WavDirDataset(hp, path=str(tmp_path / "trainonly")).install_and_load()
    out = capsys.readouterr().out
    assert out.count("aliases the TRAINING files") == 2


def test_torch_wavdir_int16_wire_refuses_float_wavs(fresh_hparams,
                                                     tmp_path):
    """Float WAVs: the waves keep their native scale (about 0.1, as JAX's),
    and under TRANSFER_DTYPE 'int16' a wave epoch refuses them, as JAX's
    does."""
    from danet_tpu.data.wavdir import WavDirDataset as JaxWavDir
    from danet_tpu_torch.data.wavdir import WavDirDataset
    hp = _hp_pair(fresh_hparams)
    _write_wavs(tmp_path / "f" / "train", 4, np.random.RandomState(3),
                dtype=np.float32, rate=4000)
    ds = WavDirDataset(hp, path=str(tmp_path / "f"))
    jds = JaxWavDir(path=str(tmp_path / "f"))
    for d in (ds, jds):
        d.install_and_load()
    _equal_epoch_pair(ds, jds, subsets=("train",))
    assert np.abs(next(iter(ds.epoch_wave("train", 2)))[0]).max() < 1.0
    hp16 = load_config(**dict(KEYS, TRANSFER_DTYPE="int16"))
    fresh_hparams.TRANSFER_DTYPE = "int16"
    for d in (WavDirDataset(hp16, path=str(tmp_path / "f")),
              JaxWavDir(path=str(tmp_path / "f"))):
        d.install_and_load()
        with pytest.raises(ValueError, match="16-bit"):
            next(iter(d.epoch_wave("train", 2)))


def test_torch_wavdir_missing_data_errors(fresh_hparams, tmp_path):
    """A subfolder layout without train/ raises IOError naming it; so do
    an empty folder, a missing one and no WAVDIR_PATH at all; an epoch
    before install_and_load raises RuntimeError."""
    from danet_tpu_torch.data.wavdir import WavDirDataset
    hp = _hp_pair(fresh_hparams)
    _write_wavs(tmp_path / "evalonly" / "test", 1, np.random.RandomState(4))
    (tmp_path / "empty").mkdir()
    for path, match in ((tmp_path / "evalonly", "train"),
                        (tmp_path / "empty", "no .wav"),
                        (tmp_path / "none", "not a directory"),
                        ("", "WAVDIR_PATH")):
        with pytest.raises(IOError, match=match):
            WavDirDataset(hp, path=str(path) if path else None) \
                .install_and_load()
    hp_dir = load_config(**dict(KEYS, WAVDIR_PATH=str(tmp_path / "empty")))
    with pytest.raises(IOError, match="no .wav"):
        WavDirDataset(hp_dir).install_and_load()
    with pytest.raises(RuntimeError):
        next(WavDirDataset(hp).epoch("train", 2))


def test_torch_load_wav_raw_native_scale_matches_jax(tmp_path):
    """load_wav_raw with normalize=False and with_dtype, for 8-bit, 16-bit
    and float WAVs, resampled and not: JAX's samples and source dtype."""
    rs = np.random.RandomState(5)
    for i, x in enumerate((rs.randint(0, 256, 900).astype(np.uint8),
                           (rs.randn(900) * 3000).astype(np.int16),
                           (rs.randn(900) * 0.1).astype(np.float32))):
        path = str(tmp_path / ("w%d.wav" % i))
        scipy.io.wavfile.write(path, 8000, x)
        for rate in (8000, 4000):
            for norm in (True, False):
                got, dt = audio.load_wav_raw(path, rate, normalize=norm,
                                             with_dtype=True)
                want, jdt = jaudio.load_wav_raw(path, rate, normalize=norm,
                                                with_dtype=True)
                assert dt == jdt == x.dtype
                np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------------- timit
def _write_timit_pickles(dirpath, n=10, feat=129):
    """tests/test_data.py's fixture: ``{train,test}_set.pkl``, each three
    pickled lists (spectra of 20-49 frames, phonemes, texts)."""
    import pickle
    rng = np.random.RandomState(0)
    os.makedirs(dirpath, exist_ok=True)
    for subset in ["train", "test"]:
        sigs = [(rng.randn(rng.randint(20, 50), feat)
                 + 1j * rng.randn(1, feat)).astype(np.complex64)
                for _ in range(n)]
        phonemes = [rng.randint(0, 60, size=(5,)).astype(np.int32)
                    for _ in range(n)]
        texts = [rng.randint(0, 27, size=(rng.randint(3, 9),)).astype(
            np.int32) for _ in range(n)]
        with open(os.path.join(dirpath, "%s_set.pkl" % subset), "wb") as f:
            pickle.dump(sigs, f, -1)
            pickle.dump(phonemes, f, -1)
            pickle.dump(texts, f, -1)


@pytest.mark.parametrize("shuffle", [True, False])
def test_torch_timit_epochs_match_jax(fresh_hparams, tmp_path, shuffle):
    """(test_data.py:42) The timit epoch, with its sparse text aux, and the
    wave epoch equal JAX's bit for bit (valid is test); 10 utterances at a
    batch of 4: two full batches and the last 4; TIMIT_DIR from the
    config; an unknown subset raises KeyError."""
    from danet_tpu.data.timit import TimitDataset as JaxTimit
    from danet_tpu_torch.data.timit import TimitDataset
    _write_timit_pickles(str(tmp_path))
    hp = _hp_pair(fresh_hparams, TIMIT_DIR=str(tmp_path))
    ds, jds = TimitDataset(hp), JaxTimit(data_dir=str(tmp_path))
    assert ds.data_dir == str(tmp_path)
    for d in (ds, jds):
        d.install_and_load()
    assert ds.subset["valid"] is ds.subset["test"]
    assert ds.WAVE_SCALE == jds.WAVE_SCALE == 32768.0
    for subset in ("train", "valid"):
        np.random.seed(11)
        random.seed(12)
        ref = list(jds.epoch(subset, 4, shuffle=shuffle))
        out = list(ds.epoch(subset, 4, shuffle=shuffle,
                            rng=np.random.RandomState(11),
                            rand=random.Random(12)))
        assert len(out) == len(ref) == 3
        for (x, (ti, tv, ts)), (y, (ri, rv, rsh)) in zip(out, ref):
            assert x.dtype == y.dtype == np.complex64
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(ti, ri)
            np.testing.assert_array_equal(tv, rv)
            assert ts == rsh and ts[0] == 4
    _equal_epoch_pair(ds, jds, names=("epoch_wave",),
                      subsets=("train", "test"), batch=4, shuffle=shuffle)
    with pytest.raises(KeyError):
        next(ds.epoch("bogus", 4))


def test_torch_timit_exact_multiple_and_codec(fresh_hparams, tmp_path):
    """(test_data.py:60,169) 12 utterances: batches of 4, 12 and 5 give 3,
    1 and 3 (the last full batch is kept); the text codec equals JAX's; a
    missing pickle raises IOError."""
    from danet_tpu.data.timit import TimitDataset as JaxTimit
    from danet_tpu_torch.data.timit import TimitDataset
    _write_timit_pickles(str(tmp_path), n=12)
    hp = _hp_pair(fresh_hparams)
    ds = TimitDataset(hp, data_dir=str(tmp_path))
    ds.install_and_load()
    assert [len(list(ds.epoch("train", b))) for b in (4, 12, 5)] == [3, 1, 3]
    s = "hello world"
    arr = TimitDataset.encode_from_str(s)
    np.testing.assert_array_equal(arr, JaxTimit.encode_from_str(s))
    assert TimitDataset.decode_to_str(arr) == s
    assert TimitDataset.PHONEME_DI == JaxTimit.PHONEME_DI
    with pytest.raises(IOError, match="TIMIT"):
        TimitDataset(hp, data_dir=str(tmp_path / "none")).install_and_load()


def test_torch_cli_trains_bilstm_on_timit(tmp_path, capsys, monkeypatch):
    """``python -m danet_tpu_torch -m train -ds timit -tl 16 -bs 2`` with
    configs/reference-parity.json (bilstm-orig, narrowed to 6 units x 2
    layers) on the pickle fixture, TIMIT_DIR set by --set; then -m debug
    and -m test from the checkpoint."""
    import danet_tpu_torch.models.encoders as tenc
    from danet_tpu_torch import __main__ as cli
    monkeypatch.setattr(tenc.BiLstmEncoder, "HDIM", 6)
    monkeypatch.setattr(tenc.BiLstmEncoder, "N_LAYERS", 2)
    _write_timit_pickles(str(tmp_path / "timit"), n=9)
    base = ["-ds", "timit", "--device", "cpu", "-c", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "reference-parity.json"),
        "--set", "TIMIT_DIR=%s" % (tmp_path / "timit"),
        "--set", "SUMMARY_DIR=%s" % (tmp_path / "logs")]
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        cli.main(base + ["-m", "train", "-ne", "1", "-tl", "16", "-bs", "2",
                         "-o", "ckpt", "--no-save-on-epoch"])
        out = capsys.readouterr().out
        assert "Epoch 1/1" in out and "Valid  1/1" in out
        assert "nan" not in out.lower()
        cli.main(base + ["-m", "debug", "-i", "ckpt"])
        assert "Debug data written" in capsys.readouterr().out
        assert os.path.exists("debug/debug_data.mat")
        cli.main(base + ["-m", "test", "-i", "ckpt", "-bs", "2"])
        out = capsys.readouterr().out
        assert "Test: " in out and "nan" not in out.lower()
    finally:
        os.chdir(here)
