"""PyTorch port, DSP: the STFT (kernel A's plain version and the plain
framing path), the iSTFT, the complex ``stft`` / ``istft`` and
``stft_mag_logmag`` (2e-5) against the JAX package on the CPU.

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


@pytest.mark.parametrize("fft, stride", [(256, 64), (256, 100), (512, 128),
                                         (256, 256)])
def test_torch_stft_plain_any_stride_matches_xla(fresh_hparams, fft, stride):
    """Kernel A's plain version against the JAX package's XLA STFT at
    strides that do and do not divide the FFT size (the CUDA kernel frames
    any stride; the TPU kernel only divisors), B=3, odd L, 2e-5."""
    from danet_tpu_torch.hparams import WINDOW_REGISTRY

    w = WINDOW_REGISTRY["sqrt-hann"](fft).astype(np.float32)
    x = np.random.RandomState(fft + stride).randn(3, 9999).astype(np.float32)
    ref = np.asarray(jdsp.stft_ri(jnp.asarray(x), fft, stride, w))
    out = cuda_stft.stft_ri(torch.from_numpy(x), fft, stride, w).numpy()
    t = tdsp.stft_frame_count(9999, fft, stride)
    assert out.shape == ref.shape == (3, t, fft // 2 + 1, 2)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("fft, blocks", [(256, 4), (512, 8), (200, 4),
                                         (30, 1)])
def test_torch_stft_kernel_basis_layout(fresh_hparams, fft, blocks):
    """The kernel's cached basis layout holds exactly the plain basis's
    values, column for column: column c in block c // 64 at c % 64, the
    pair beyond 64 x blocks (2F = fft + 2) folded into the last block at 64
    and 65, a larger remainder in a block of its own; every other entry
    (padding columns, rows up to the fft rounded to 4) zero."""
    w = np.hanning(fft).astype(np.float32) + 0.5
    plain = cuda_stft._basis(fft, 64, w, torch.device("cpu")).numpy()
    kernel = cuda_stft._basis(fft, 64, w, torch.device("cpu"),
                              kernel=True).numpy()
    n_cols = 2 * (fft // 2 + 1)
    assert plain.shape == (fft, n_cols)
    assert kernel.shape == (blocks, -(-fft // 4) * 4, cuda_stft.ROW_COLS)
    seen = np.zeros(kernel.shape, bool)
    for c in range(n_cols):
        j = min(c // 64, blocks - 1)
        np.testing.assert_array_equal(kernel[j, :fft, c - 64 * j],
                                      plain[:, c])
        seen[j, :fft, c - 64 * j] = True
    assert not kernel[~seen].any()
    assert cuda_stft._basis(fft, 64, w, torch.device("cpu"),
                            kernel=True) is cuda_stft._basis(
        fft, 64, w, torch.device("cpu"), kernel=True)


@pytest.mark.parametrize("logmag", [False, True])
def test_torch_stft_launch_passes_kernel_layout(fresh_hparams, monkeypatch,
                                                logmag):
    """stft_ri hands danet_stft_ri its arguments in the order of its
    extern "C" declaration: the wave, the basis in the kernel's layout, the
    output, then (B, L, T, fft, stride, 2F, logmag) and the stream; one
    launch counted under the right counter.  Recorded on the CPU with the
    kernel library replaced."""
    import contextlib
    import types

    from danet_tpu_torch.ops.cuda import _build
    from test_torch_rnn import _c_arg_names

    calls = []

    class Lib:
        def danet_stft_ri(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(cuda_stft, "_on_cuda", lambda x, what: True)
    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    w = fresh_hparams.FFT_WND_ARRAY
    x = torch.zeros(3, 12345)
    counts = (cuda_stft.stft_ri.launches, cuda_stft.stft_logmag.launches)
    out = cuda_stft.stft_ri(x, 256, 100, w, logmag=logmag)
    (args,) = calls
    names = _c_arg_names("danet_stft_ri")
    assert names == ["x", "basis", "out", "batch", "length", "n_frames",
                     "fft_size", "stride", "n_cols", "logmag", "stream"]
    by_name = dict(zip(names, args))
    t = tdsp.stft_frame_count(12345, 256, 100)
    basis = cuda_stft._basis(256, 100, w, x.device, kernel=True)
    assert by_name["x"] == x.data_ptr() and by_name["out"] == out.data_ptr()
    assert by_name["basis"] == basis.data_ptr()
    np.testing.assert_array_equal(
        basis.numpy(), cuda_stft.kernel_basis_np(cuda_stft._basis_np(256, w)))
    assert args[3:] == (3, 12345, t, 256, 100, 258, int(logmag), 7)
    assert tuple(out.shape) == (3, t, 129, 2)
    assert (cuda_stft.stft_ri.launches, cuda_stft.stft_logmag.launches) == (
        counts[0] + (not logmag), counts[1] + logmag)


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


# ------------------------------------------- complex STFT, kernel 6's caller
@pytest.mark.parametrize("shape", [(2, 5000), (3000,), (2, 2, 1234)])
def test_torch_complex_stft_matches_jax(fresh_hparams, shape):
    """``dsp.stft`` (complex64 out) against JAX's ``stft``, 2e-5, on
    leading axes of any rank."""
    w = fresh_hparams.FFT_WND_ARRAY
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = np.asarray(jdsp.stft(jnp.asarray(x), 256, 64, w))
    out = tdsp.stft(torch.from_numpy(x), 256, 64, w)
    assert out.dtype == torch.complex64 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("length", [None, 1000])
def test_torch_complex_istft_matches_jax(fresh_hparams, length):
    """``dsp.istft`` of complex spectra against JAX's ``istft``, 2e-5, and
    ``istft(stft(x))`` against JAX's (the reference's overlap-add keeps
    the STFT's boundary offset, so it is not x)."""
    w = fresh_hparams.FFT_WND_ARRAY
    rs = np.random.RandomState(3)
    spec = (rs.randn(2, 40, 129) + 1j * rs.randn(2, 40, 129)).astype(
        np.complex64)
    ref = np.asarray(jdsp.istft(jnp.asarray(spec), 64, w, length))
    out = tdsp.istft(torch.from_numpy(spec), 64, w, length)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    x = rs.randn(2, 4000).astype(np.float32)
    back = tdsp.istft(tdsp.stft(torch.from_numpy(x), 256, 64, w), 64, w,
                      4000)
    back_j = jdsp.istft(jdsp.stft(jnp.asarray(x), 256, 64, w), 64, w, 4000)
    np.testing.assert_allclose(back.numpy(), np.asarray(back_j), atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 5000), (3001,)])
def test_torch_stft_mag_logmag_matches_jax(fresh_hparams, shape):
    """``dsp.stft_mag_logmag`` (kernel 6's op on the CPU: its plain
    version) against JAX's, 2e-5; no kernel launch is counted."""
    w = fresh_hparams.FFT_WND_ARRAY
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    mag_j, log_j = jdsp.stft_mag_logmag(jnp.asarray(x), 256, 64, w)
    launches = cuda_stft.stft_logmag.launches
    mag, logmag = tdsp.stft_mag_logmag(torch.from_numpy(x), 256, 64, w)
    assert cuda_stft.stft_logmag.launches == launches
    assert tuple(mag.shape) == tuple(logmag.shape) == mag_j.shape
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_j), atol=2e-5)
    np.testing.assert_allclose(logmag.numpy(), np.asarray(log_j), atol=2e-5)
