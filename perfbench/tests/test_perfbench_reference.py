"""The plain reference against the program at a tiny size on the CPU (the
program's plain versions of its kernels): the training loss and its
gradient for each configuration, and a served separation."""
import numpy as np
import pytest
import torch

from perfbench.harness import traffic as traffic_mod
from perfbench.harness import weights as weights_mod
from perfbench.reference import danet as ref
from perfbench.tests import tiny


def _model(c):
    from danet_tpu_torch.hparams import load_config
    hp = load_config(**c.keys)
    return hp.get_model()(hp)


def _loss_and_grads(fn, params):
    leaves = [p.clone().requires_grad_(True) for p in ref.leaves(params)]
    tree = ref._rebuild(params, iter(leaves))
    loss = fn(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("config, aux", [("danet-bilstm", None),
                                         ("multichip-dp4", None),
                                         ("dprnn", 0.0)])
def test_train_loss_and_gradient(config, aux, monkeypatch):
    """dprnn's k-means auxiliary is off here: the program's two-source
    k-means takes the second centroid as the totals minus the first, a
    cancelling difference whose gradient departs from the reference's
    (PERF.md, Open questions); its value is held below."""
    c = tiny.cell("danet-bilstm.train", monkeypatch, config=config)
    if aux is not None:
        c.config["ANCHOR_AUX_LOSS"] = aux
    model = _model(c)
    params = weights_mod.make(c.keys, c.widths, c.seed, "cpu")
    src = torch.from_numpy(traffic_mod.make(c.traffic, c.keys, c.seed)
                           .batches(0, 1)[0])
    got, g_got = _loss_and_grads(
        lambda p: model.train_loss(p, src)[0], params)
    want, g_want = _loss_and_grads(
        lambda p: ref.train_loss(c.keys, p, src, torch.float32), params)
    assert got == pytest.approx(want, rel=1e-5)
    norms = [float(g.norm()) for g in g_want]
    floor = 1e-3 * float(np.median(norms))
    for a, b, n in zip(g_got, g_want, norms):
        if n > floor:
            assert float((a - b).norm()) <= 1e-4 * max(n, np.median(norms))


def test_dprnn_auxiliary_loss_value(monkeypatch):
    c = tiny.cell("danet-bilstm.train", monkeypatch, config="dprnn")
    model = _model(c)
    params = weights_mod.make(c.keys, c.widths, c.seed, "cpu")
    src = torch.from_numpy(traffic_mod.make(c.traffic, c.keys, c.seed)
                           .batches(0, 1)[0])
    got = float(model.train_loss(params, src)[0])
    want = float(ref.train_loss(c.keys, params, src, torch.float32))
    assert got == pytest.approx(want, rel=1e-5)


def test_separate_wav(monkeypatch):
    c = tiny.cell("danet-bilstm.serve", monkeypatch)
    model = _model(c)
    params = weights_mod.make(c.keys, c.widths, c.seed, "cpu")
    t = traffic_mod.make(c.traffic, c.keys, c.seed)
    waves = [torch.from_numpy(t.request(i)) for i in range(3)]
    want = ref.separate(c.keys, params, waves)
    for w, r in zip(waves, want):
        with torch.no_grad():
            got = model.separate_wav(params, w[None])[0, :, :w.shape[0]]
        assert got.shape == r.shape
        assert float((got - r).abs().max() / r.abs().max()) < 1e-5


def test_reference_stft_is_scipys(monkeypatch):
    c = tiny.cell("danet-bilstm.serve", monkeypatch)
    from perfbench.harness import synth
    w = traffic_mod.make(c.traffic, c.keys, c.seed).request(0)
    got = ref.stft(torch.from_numpy(w)[None], 256, 64)[0].numpy()
    want = synth.stft_ri(w, 256, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
