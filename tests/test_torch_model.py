"""PyTorch port, model: encoder, anchor estimator, separators, ``separate``
and the whole serving slice ``separate_wav`` against the JAX package on
the CPU, with the same weights (carried by ``danet_tpu_torch.weights``)
and the same numpy inputs.

Narrow widths (HDIM and N_LAYERS patched on BOTH packages' encoder
classes) except one encoder check at full width.  Tolerances: 1e-5
(relative and absolute) on module outputs, float32 sums in another order;
1e-4 on ``separate_wav``, the JAX kernel tests' bar for the slice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# the recurrent encoders by registry key: (JAX class, port class)
ENCODERS = {
    "bilstm-orig": (jenc.BiLstmEncoder, tenc.BiLstmEncoder),
    "lstm-orig": (jenc.LstmEncoder, tenc.LstmEncoder),
    "gru-v1": (jenc.GruEncoder, tenc.GruEncoder),
}


def _pair(hp_jax, monkeypatch, hdim=8, layers=2, encoder="bilstm-orig",
          **keys):
    """(jax model, jax params, torch model, torch params) at the given
    encoder width, built from default.json + ENCODER_TYPE=encoder."""
    for cls in ENCODERS[encoder]:
        monkeypatch.setattr(cls, "HDIM", hdim)
        monkeypatch.setattr(cls, "N_LAYERS", layers)
    keys = dict(ENCODER_TYPE=encoder, **keys)
    hp_jax.load(keys)
    hp_jax.digest()
    jmodel = JaxDaNet()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = TorchDaNet(load_config(**keys))
    tparams = weights.from_jax(jax.device_get(jparams))
    return jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("legacy", [False, True])
def test_torch_encoder_matches_jax(fresh_hparams, monkeypatch, legacy):
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch,
                           LSTM_LEGACY_CELL=legacy)
    x = np.abs(np.random.RandomState(0).randn(2, 9, 129)).astype(np.float32)
    ref = jm.encoder.apply(jp["encoder"], jnp.asarray(x))
    out = tm.encoder.apply(tp["encoder"], torch.from_numpy(x))
    assert tuple(out.shape) == (2, 9, 129, 20)
    _close(out, ref)


def test_torch_encoder_full_width_matches_jax(fresh_hparams, monkeypatch):
    """bilstm-orig at its real widths (4 layers, H=300) on a short T, so
    the weight bridge is proven at the shapes the chip runs."""
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch, hdim=300, layers=4)
    assert tp["encoder"]["lstm3"]["bwd"]["wh"].shape == (300, 4, 300)
    x = np.abs(np.random.RandomState(1).randn(1, 5, 129)).astype(np.float32)
    ref = jm.encoder.apply(jp["encoder"], jnp.asarray(x))
    out = tm.encoder.apply(tp["encoder"], torch.from_numpy(x))
    _close(out, ref)


@pytest.mark.parametrize("n_src", [2, 3])
def test_torch_anchor_estimator_matches_jax(fresh_hparams, monkeypatch,
                                            n_src):
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch, MAX_N_SIGNAL=n_src)
    embed = np.random.RandomState(2).randn(3, 6, 129, 20).astype(np.float32)
    ref = np.asarray(jm.infer_estimator.apply(
        jp["infer_estimator"], jnp.asarray(embed)))
    sets, choice = tm.infer_estimator.subset_choice(
        tp["infer_estimator"], torch.from_numpy(embed))
    # the subset JAX chose, found among the port's candidate sets
    jax_choice = np.argmin(np.abs(sets.numpy() - ref[:, None]).reshape(
        sets.shape[0], sets.shape[1], -1).max(-1), axis=1)
    np.testing.assert_array_equal(choice.numpy(), jax_choice)
    out = tm.infer_estimator.apply(tp["infer_estimator"],
                                   torch.from_numpy(embed))
    assert tuple(out.shape) == (3, n_src, 20)
    _close(out, ref)


def test_torch_truth_weighted_estimator_matches_jax(fresh_hparams,
                                                    monkeypatch):
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch)
    rs = np.random.RandomState(3)
    embed = rs.randn(2, 5, 129, 20).astype(np.float32)
    src_pwr = np.abs(rs.randn(2, 2, 5, 129)).astype(np.float32)
    mix_pwr = src_pwr.sum(1)
    ref = jm.train_estimator.apply({}, jnp.asarray(embed),
                                   jnp.asarray(src_pwr), jnp.asarray(mix_pwr))
    out = tm.train_estimator.apply({}, torch.from_numpy(embed),
                                   torch.from_numpy(src_pwr),
                                   torch.from_numpy(mix_pwr))
    _close(out, ref)


@pytest.mark.parametrize("sep", ["dot-sigmoid-orig", "dot-softmax-orig"])
def test_torch_separator_matches_jax(fresh_hparams, monkeypatch, sep):
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch, SEPARATOR_TYPE=sep)
    rs = np.random.RandomState(4)
    mix_pwr = np.abs(rs.randn(2, 7, 129)).astype(np.float32)
    att = rs.randn(2, 2, 20).astype(np.float32)
    emb = rs.randn(2, 7 * 129, 20).astype(np.float32)
    ref = jm.separator.apply({}, *map(jnp.asarray, (mix_pwr, att, emb)))
    out = tm.separator.apply({}, *map(torch.from_numpy, (mix_pwr, att, emb)))
    assert tuple(out.shape) == (2, 2, 7, 129)
    _close(out, ref)


def test_torch_separate_matches_jax(fresh_hparams, monkeypatch):
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch)
    mix_ri = np.random.RandomState(5).randn(2, 11, 129, 2).astype(np.float32)
    ref = jm.separate(jp, jnp.asarray(mix_ri))
    out = tm.separate(tp, torch.from_numpy(mix_ri))
    assert tuple(out.shape) == (2, 2, 11, 129, 2)
    _close(out, ref)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """danet_tpu's Pallas STFT with pallas_call in interpret mode."""
    import danet_tpu.ops.pallas.stft as pstft

    orig = pstft.pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pstft.pl, "pallas_call", interp_call)
    pstft._stft_pallas_padded._clear_cache()
    yield
    pstft._stft_pallas_padded._clear_cache()


def test_torch_separate_wav_slice_matches_jax(fresh_hparams, monkeypatch,
                                              interpret_pallas):
    """The whole serving slice: wave -> STFT -> bilstm-orig -> anchor ->
    sigmoid masks -> iSTFT.  The JAX side runs both of its Pallas kernels
    on this path in interpret mode."""
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch)
    fresh_hparams.STFT_BACKEND = "pallas"
    fresh_hparams.LSTM_BACKEND = "pallas-interpret"
    wav = (np.random.RandomState(6).randn(2, 3001) * 0.5).astype(np.float32)
    ref = np.asarray(jm.separate_wav(jp, jnp.asarray(wav)))
    out = tm.separate_wav(tp, torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (2, 2, 48 * 64)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # the plain STFT path of the port agrees too
    tm.hp.STFT_BACKEND = "xla"
    np.testing.assert_allclose(
        tm.separate_wav(tp, torch.from_numpy(wav)).numpy(), ref, atol=1e-4)
    tm.hp.STFT_BACKEND = "fft"
    with pytest.raises(ValueError):
        tm.separate_wav(tp, torch.from_numpy(wav))


def test_torch_toy_encoder_matches_jax(fresh_hparams):
    """The default.json encoder (a 3-layer MLP)."""
    fresh_hparams.ENCODER_TYPE = "toy"
    jmodel = JaxDaNet()
    jp = jmodel.init(jax.random.PRNGKey(1))
    tmodel = TorchDaNet(load_config(ENCODER_TYPE="toy"))
    x = np.abs(np.random.RandomState(7).randn(2, 6, 129)).astype(np.float32)
    ref = jmodel.encoder.apply(jp["encoder"], jnp.asarray(x))
    out = tmodel.encoder.apply(weights.from_jax(jax.device_get(jp))["encoder"],
                               torch.from_numpy(x))
    assert tuple(out.shape) == (2, 6, 129, 20)
    _close(out, ref)


@pytest.mark.parametrize("encoder,legacy", [
    ("lstm-orig", False), ("lstm-orig", True), ("gru-v1", False)])
def test_torch_unidirectional_encoder_matches_jax(fresh_hparams, monkeypatch,
                                                  encoder, legacy):
    """lstm-orig (tanh and the legacy linear candidate) and gru-v1 at
    narrow width against the JAX encoders' Pallas kernels (interpret)."""
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch, encoder=encoder,
                           LSTM_LEGACY_CELL=legacy)
    fresh_hparams.LSTM_BACKEND = "pallas-interpret"
    x = np.abs(np.random.RandomState(8).randn(2, 9, 129)).astype(np.float32)
    ref = jm.encoder.apply(jp["encoder"], jnp.asarray(x))
    out = tm.encoder.apply(tp["encoder"], torch.from_numpy(x))
    assert tuple(out.shape) == (2, 9, 129, 20)
    _close(out, ref)


@pytest.mark.parametrize("encoder", ["lstm-orig", "gru-v1"])
def test_torch_unidirectional_separate_wav_matches_jax(
        fresh_hparams, monkeypatch, interpret_pallas, encoder):
    """The serving slice with lstm-orig and gru-v1: wave -> STFT -> 2
    one-direction layers -> anchor -> sigmoid masks -> iSTFT, the JAX side
    on its Pallas STFT and recurrent kernels in interpret mode, 1e-4."""
    jm, jp, tm, tp = _pair(fresh_hparams, monkeypatch, encoder=encoder)
    fresh_hparams.STFT_BACKEND = "pallas"
    fresh_hparams.LSTM_BACKEND = "pallas-interpret"
    wav = (np.random.RandomState(9).randn(2, 3001) * 0.5).astype(np.float32)
    ref = np.asarray(jm.separate_wav(jp, jnp.asarray(wav)))
    out = tm.separate_wav(tp, torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (2, 2, 48 * 64)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("encoder,keys,jax_refuses", [
    ("lstm-orig", {"MESH_SEQ": 2}, True),
    ("gru-v1", {"MESH_PIPE": 2}, True),
    ("bilstm-orig", {"MESH_EXPERT": 2}, True),
    ("bilstm-orig", {"MESH_PIPE": 2, "MESH_SEQ": 2}, True),
    ("bilstm-orig", {"MESH_SEQ": 2}, False),
    ("gru-v1", {"MESH_SEQ": 2}, False),
    ("bilstm-orig", {"MESH_PIPE": 2}, False),
    ("bilstm-orig", {"MESH_DATA": 2}, False),
    ("lstm-orig", {"MESH_MODEL": 2}, False),
    ("tcn-v1", {"MESH_SEQ": 2}, False),
    ("dprnn-v1", {"MESH_SEQ": 2}, False),
    ("conv-bilstm-v1", {"MESH_SEQ": 2}, False),
    ("tcn-v1", {"MESH_PIPE": 2}, True)])
def test_torch_danet_refuses_mesh_keys(fresh_hparams, encoder, keys,
                                       jax_refuses):
    """DaNet raises JAX's _check_parallel_support ValueError, with JAX's
    message, where JAX refuses the MESH_* combination; where JAX builds
    the model, the port (one device) raises NotImplementedError, so that
    neither serving nor training runs the dense path under the key."""
    fresh_hparams.load(dict(ENCODER_TYPE=encoder, **keys))
    fresh_hparams.digest()
    hp = load_config(ENCODER_TYPE=encoder, **keys)
    if jax_refuses:
        with pytest.raises(ValueError) as want:
            JaxDaNet()
        with pytest.raises(ValueError) as got:
            TorchDaNet(hp)
        assert str(got.value) == str(want.value)
    else:
        JaxDaNet()
        with pytest.raises(NotImplementedError):
            TorchDaNet(hp)
