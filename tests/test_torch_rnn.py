"""PyTorch port, BiLSTM: kernel B's plain version and ``bilstm_apply``
against the JAX package's fused Pallas BiLSTM in interpret mode.

Forward only, float32, atol 1e-6 (the JAX kernel tests' forward bar).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from danet_tpu.ops import rnn as jrnn  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.ops import rnn as trnn  # noqa: E402
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402


@pytest.mark.parametrize("act", ["tanh", "linear"])
def test_torch_bilstm_apply_matches_pallas_interpret(fresh_hparams, act):
    T, B, I, H = 8, 3, 5, 6
    params = jrnn.bilstm_init(jax.random.PRNGKey(7), I, H,
                              gate_bias=(0.0, 1.5, -1.0, 1.0))
    x = np.random.RandomState(7).randn(B, T, I).astype(np.float32)
    ref = np.asarray(jrnn.bilstm_apply(params, jnp.asarray(x), act,
                                       backend="pallas-interpret"))
    tparams = weights.from_jax(jax.device_get(params))
    for backend in ("auto", "pallas", "xla"):
        out = trnn.bilstm_apply(tparams, torch.from_numpy(x), act,
                                backend=backend).numpy()
        assert out.shape == (B, T, 2 * H)
        np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("tanh_cand", [True, False])
def test_torch_bilstm_scan_plain_matches_pallas_interpret(fresh_hparams,
                                                          tanh_cand):
    """The scan alone, with nonzero initial state (the kernel's full
    contract, not only the zeros bilstm_apply passes)."""
    from danet_tpu.ops.pallas.lstm import bilstm_scan_pallas

    T, B, H = 7, 2, 5
    rs = np.random.RandomState(3)
    xp = rs.randn(T, 2, B, 4 * H).astype(np.float32)
    wh = (rs.randn(2, H, 4 * H) * 0.4).astype(np.float32)
    c0 = rs.randn(2, B, H).astype(np.float32)
    h0 = rs.randn(2, B, H).astype(np.float32)
    ref = np.asarray(bilstm_scan_pallas(*map(jnp.asarray, (xp, wh, c0, h0)),
                                        tanh_cand, True))
    args = [torch.from_numpy(a) for a in (xp, wh, c0, h0)]
    before = cuda_lstm.bilstm_scan.launches
    out = cuda_lstm.bilstm_scan(*args, tanh_cand).numpy()
    assert cuda_lstm.bilstm_scan.launches == before  # CPU: plain version
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_torch_bilstm_rejects_unknown_backend(fresh_hparams):
    tparams = {d: {"wx": torch.zeros(2, 4, 3), "wh": torch.zeros(3, 4, 3),
                   "b": torch.zeros(4, 3)} for d in ("fwd", "bwd")}
    with pytest.raises(ValueError):
        trnn.bilstm_apply(tparams, torch.zeros(1, 4, 2), backend="cudnn")
