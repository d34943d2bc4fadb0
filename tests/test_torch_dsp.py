"""PyTorch port, DSP: the STFT (kernel A's plain version and the plain
framing path) and the iSTFT against the JAX package on the CPU.

The JAX STFT kernel runs as tests/test_pallas.py runs it here: pallas_call
patched to interpret mode.  Tolerances: 2e-5 on the STFT (as the JAX
kernel's own test), 1e-6 on the iSTFT (float32 sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from danet_tpu.ops import dsp as jdsp  # noqa: E402
from danet_tpu_torch.ops import dsp as tdsp  # noqa: E402
from danet_tpu_torch.ops.cuda import stft as cuda_stft  # noqa: E402


@pytest.fixture
def interpret_stft(monkeypatch):
    """danet_tpu's Pallas STFT with pallas_call in interpret mode."""
    import danet_tpu.ops.pallas.stft as pstft

    orig = pstft.pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pstft.pl, "pallas_call", interp_call)
    pstft._stft_pallas_padded._clear_cache()
    yield pstft
    pstft._stft_pallas_padded._clear_cache()


@pytest.mark.parametrize("length", [12000, 12345])
def test_torch_stft_matches_pallas_and_xla(fresh_hparams, interpret_stft,
                                           length):
    w = fresh_hparams.FFT_WND_ARRAY
    x = np.random.RandomState(0).randn(2, length).astype(np.float32)
    ref_pallas = np.asarray(
        interpret_stft.stft_ri_pallas(jnp.asarray(x), 256, 64, w))
    ref_xla = np.asarray(jdsp.stft_ri(jnp.asarray(x), 256, 64, w))
    tx = torch.from_numpy(x)
    kernel_path = cuda_stft.stft_ri(tx, 256, 64, w).numpy()   # CPU: plain
    plain_path = tdsp.stft_ri(tx, 256, 64, w).numpy()
    t = tdsp.stft_frame_count(length, 256, 64)
    assert kernel_path.shape == ref_pallas.shape == (2, t, 129, 2)
    np.testing.assert_allclose(kernel_path, ref_pallas, atol=2e-5)
    np.testing.assert_allclose(kernel_path, ref_xla, atol=2e-5)
    np.testing.assert_allclose(plain_path, ref_xla, atol=2e-5)
    # rank-1 input keeps the batch axis squeezed, as stft_ri_pallas
    np.testing.assert_array_equal(
        cuda_stft.stft_ri(tx[0], 256, 64, w).numpy(), kernel_path[0])


def test_torch_stft_logmag_matches_pallas(fresh_hparams, interpret_stft):
    """Kernel 6's plain version, (|Z|, log1p|Z|), against the JAX kernel's
    logmag branch in interpret mode, 2e-5; on a CPU tensor neither counter
    moves."""
    w = fresh_hparams.FFT_WND_ARRAY
    x = np.random.RandomState(1).randn(2, 8000).astype(np.float32)
    ref = np.asarray(interpret_stft.stft_ri_pallas(jnp.asarray(x), 256, 64,
                                                   w, logmag=True))
    before = (cuda_stft.stft_ri.launches, cuda_stft.stft_logmag.launches)
    out = cuda_stft.stft_logmag(torch.from_numpy(x), 256, 64, w).numpy()
    assert before == (cuda_stft.stft_ri.launches,
                      cuda_stft.stft_logmag.launches)
    assert out.shape == ref.shape == (2, 126, 129, 2)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_array_equal(
        cuda_stft.stft_ri(torch.from_numpy(x), 256, 64, w,
                          logmag=True).numpy(), out)


def test_torch_stft_wrapper_counts_only_kernel_launches(fresh_hparams):
    before = cuda_stft.stft_ri.launches
    cuda_stft.stft_ri(torch.zeros(1, 1000), 256, 64,
                      fresh_hparams.FFT_WND_ARRAY)
    assert cuda_stft.stft_ri.launches == before  # CPU tensor: plain path
    with pytest.raises(ValueError):
        cuda_stft.stft_ri(torch.zeros(1, 2, 3), 256, 64,
                          fresh_hparams.FFT_WND_ARRAY)


@pytest.mark.parametrize("frames", [40, 57])
def test_torch_istft_matches_jax(fresh_hparams, frames):
    w = fresh_hparams.FFT_WND_ARRAY
    spec = np.random.RandomState(1).randn(2, 3, frames, 129, 2).astype(
        np.float32)
    ref = np.asarray(jdsp.istft_ri(jnp.asarray(spec), 64, w))
    out = tdsp.istft_ri(torch.from_numpy(spec), 64, w).numpy()
    assert out.shape == ref.shape == (2, 3, frames * 64)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    ref_len = np.asarray(jdsp.istft_ri(jnp.asarray(spec), 64, w, 1000))
    out_len = tdsp.istft_ri(torch.from_numpy(spec), 64, w, 1000).numpy()
    np.testing.assert_allclose(out_len, ref_len, atol=1e-6)
