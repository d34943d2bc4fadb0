"""PyTorch port, weight bridge: JAX tree -> port -> JAX tree, save_npz /
load_npz, and the serve CLI on a saved tree (CPU, narrow widths)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import danet_tpu.models.encoders as jenc  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
import danet_tpu_torch.models.encoders as tenc  # noqa: E402
from danet_tpu_torch import serve, weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402
from danet_tpu_torch.models import DaNet as TorchDaNet  # noqa: E402


@pytest.fixture
def jax_tree(fresh_hparams, monkeypatch):
    for cls in (jenc.BiLstmEncoder, tenc.BiLstmEncoder):
        monkeypatch.setattr(cls, "HDIM", 6)
        monkeypatch.setattr(cls, "N_LAYERS", 2)
    fresh_hparams.ENCODER_TYPE = "bilstm-orig"
    fresh_hparams.digest()
    model = JaxDaNet()
    return model, jax.device_get(model.init(jax.random.PRNGKey(0)))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_torch_weights_round_trip(jax_tree):
    _, tree = jax_tree
    tparams = weights.from_jax(tree)
    assert isinstance(tparams["encoder"]["lstm1"]["fwd"]["wx"], torch.Tensor)
    assert tparams["encoder"]["lstm1"]["fwd"]["wx"].shape == (12, 4, 6)
    back = weights.to_jax(tparams)
    a, b = _leaves(tree), _leaves(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    # the structure is the port model's own: its init has the same keys
    port = TorchDaNet(load_config(ENCODER_TYPE="bilstm-orig"))
    mine = _leaves(weights.to_jax(port.init(torch.Generator().manual_seed(0))))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in a.items()}


def test_torch_weights_npz_round_trip(jax_tree, tmp_path):
    model, tree = jax_tree
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, tree)
    loaded = weights.load_npz(path)
    a, b = _leaves(tree), _leaves(weights.to_jax(loaded))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # a tree with parameter-less components dropped still separates
    port = TorchDaNet(load_config(ENCODER_TYPE="bilstm-orig"))
    mix_ri = np.random.RandomState(0).randn(1, 6, 129, 2).astype(np.float32)
    ref = model.separate(tree, jnp.asarray(mix_ri))
    out = port.separate(loaded, torch.from_numpy(mix_ri))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_torch_serve_cli_run(jax_tree, tmp_path):
    """`python -m danet_tpu_torch.serve run` end to end on the CPU."""
    import json

    from danet_tpu_torch.data import audio

    model, tree = jax_tree
    w_path, cfg = str(tmp_path / "w.npz"), str(tmp_path / "cfg.json")
    weights.save_npz(w_path, tree)
    with open(cfg, "w") as f:
        json.dump({"ENCODER_TYPE": "bilstm-orig"}, f)
    wav = (np.random.RandomState(1).randn(2500) * 0.3).astype(np.float32)
    wav_path = str(tmp_path / "mix.wav")
    audio.save_wav_raw(wav_path, wav, 8000)
    prefix = str(tmp_path / "out")
    serve._main(["run", "-c", cfg, "-w", w_path, "-if", wav_path,
                 "-o", prefix, "--device", "cpu"])
    sep = serve.load_separator(w_path, [cfg], "cpu")
    ref = sep.separate(audio.load_wav_raw(wav_path, 8000))
    assert ref.shape == (2, 2500)
    for i in range(2):
        got = audio.load_wav_raw("%s_%d.wav" % (prefix, i), 8000)
        assert got.shape == (2500,)
        np.testing.assert_allclose(got, ref[i], atol=2.0 / 32767)


@pytest.mark.parametrize("shape", [(2500,), (3, 1999)])
def test_torch_separator_trims_and_squeezes(jax_tree, shape):
    """Separator.separate returns [N, L] for a rank-1 request and [B, N, L]
    for a rank-2 one, trimmed to the request length L (not a multiple of
    FFT_STRIDE here), as the JAX package's SeparatorBundle.separate does;
    the values are JAX's separate_wav trimmed to L, 1e-4."""
    model, tree = jax_tree
    wav = (np.random.RandomState(2).randn(*shape) * 0.3).astype(np.float32)
    sep = serve.Separator(TorchDaNet(load_config(ENCODER_TYPE="bilstm-orig")),
                          tree, "cpu")
    out = sep.separate(wav)
    assert out.shape == shape[:-1] + (2, shape[-1])
    ref = np.asarray(model.separate_wav(tree, jnp.asarray(wav.reshape(
        -1, shape[-1]))))
    assert ref.shape[-1] > shape[-1]
    np.testing.assert_allclose(out, ref[..., :shape[-1]].reshape(out.shape),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("encoder,cls,layer", [
    ("lstm-orig", "LstmEncoder", {"wx": (129, 4, 6), "wh": (6, 4, 6),
                                  "b": (4, 6)}),
    ("gru-v1", "GruEncoder", {"wgx": (129, 2, 6), "wgh": (6, 2, 6),
                              "bg": (2, 6), "wcx": (129, 6),
                              "wch": (6, 6), "bc": (6,)})])
def test_torch_weights_round_trip_unidirectional(fresh_hparams, monkeypatch,
                                                 tmp_path, encoder, cls,
                                                 layer):
    """The lstm{i}/{wx,wh,b} and gru{i}/{wgx,wgh,bg,wcx,wch,bc} trees cross
    the bridge key for key (from_jax / to_jax and save_npz / load_npz),
    with the port's own init giving the same keys and shapes."""
    for mod in (jenc, tenc):
        monkeypatch.setattr(getattr(mod, cls), "HDIM", 6)
        monkeypatch.setattr(getattr(mod, cls), "N_LAYERS", 2)
    fresh_hparams.ENCODER_TYPE = encoder
    fresh_hparams.digest()
    tree = jax.device_get(JaxDaNet().init(jax.random.PRNGKey(1)))
    prefix = "lstm" if encoder == "lstm-orig" else "gru"
    assert {k: tuple(v.shape) for k, v in
            tree["encoder"][prefix + "0"].items()} == layer
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, tree)
    a = _leaves(tree)
    for back in (weights.to_jax(weights.from_jax(tree)),
                 weights.to_jax(weights.load_npz(path))):
        b = _leaves(back)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    port = TorchDaNet(load_config(ENCODER_TYPE=encoder))
    mine = _leaves(weights.to_jax(port.init(torch.Generator().manual_seed(0))))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in a.items()}
