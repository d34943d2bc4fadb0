"""The kernels that only the card can run, against their plain versions
on the same card: the saving LSTM forward's state entry
(``lstm_scan_train_state``: float32 c0 and final carry c_T) and kernel 3
seeded with the carry's cotangent (``lstm_scan_bwd_seeded``), at the
relay's chunk shape (H=300, T=32, B=4) and at the training shape (H=600,
T=128, B=32), float32 and bfloat16; kernels B, 2 and 3 at dprnn-v1's
shapes (H=128, two directions: intra T=64, B=96; inter T=3, B=2048),
where they run in row groups, also bit for bit against the G = 1 launch
(``groups=1``).  Tolerances are chip_smoke.py phase
6's: float32 1e-5 on the forward and 2e-5 + 1e-4 |x| on the backward,
bfloat16 5e-2 + 2e-2 |x| (one-ulp roundings of the stored values compound
over the recurrence).  This file imports no JAX: the card's machine has
none.  Run on the card with ``python -m pytest -m card
tests/test_torch_card_kernels.py``; without a card every test skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from danet_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402

TOL = {torch.float32: ((1e-5, 0.0), (2e-5, 1e-4)),
       torch.bfloat16: ((5e-2, 2e-2), (5e-2, 2e-2))}


def _inputs(t, b, h, dtype, seed):
    rs = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(h)

    def r(*shape, s=1.0):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32))
    xp = r(t, b, 4 * h, s=0.5) + torch.tensor(
        np.repeat(np.float32([0.0, 1.5, -1.0, 1.0]), h))
    wh = torch.from_numpy(rs.uniform(-scale, scale, (h, 4 * h)).astype(
        np.float32))
    c0, h0, d_hs, dc_t = r(b, h, s=0.5), r(b, h, s=0.5), r(t, b, h, s=0.1), \
        r(b, h, s=0.1)
    dev = torch.device("cuda")
    return (xp.to(dev, dtype), wh.to(dev, dtype), c0.to(dev),
            h0.to(dev, dtype), d_hs.to(dev, dtype), dc_t.to(dev))


def _within(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    assert bool(torch.all(err <= atol + rtol * want.float().abs())), \
        float(err.max())


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,b,h", [(32, 4, 300), (128, 32, 600)])
def test_torch_card_state_forward_and_seeded_backward(t, b, h, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    dt = getattr(torch, dtype)
    xp, wh, c0, h0, d_hs, dc_t = _inputs(t, b, h, dt, t + b)
    fwd_tol, bwd_tol = TOL[dt]
    got = cuda_lstm.lstm_scan_train_state(xp, wh, c0, h0, True)
    want = cuda_lstm.lstm_scan_train_state_plain(xp, wh, c0, h0, True)
    for g, w in zip(got, want):
        _within(g, w, *fwd_tol)
    hs, cs, acts, _ = want
    c_prev = torch.cat([c0[None].to(dt), cs[:-1]])
    got = cuda_lstm.lstm_scan_bwd_seeded(d_hs, acts, cs, c_prev, wh, True,
                                         dc_t)
    want = cuda_lstm.lstm_scan_bwd_plain(d_hs, acts, cs, c_prev, wh, True,
                                         dc_t)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _within(g, w, *bwd_tol)


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,b", [(64, 96), (3, 2048)])
def test_torch_card_row_groups_match_one_group(t, b, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    dt = getattr(torch, dtype)
    h = 128
    rs = np.random.RandomState(t + b)
    scale = 1.0 / np.sqrt(h)
    dev = torch.device("cuda")

    def r(*shape, s=1.0):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32)) \
            .to(dev, dt)
    xp = r(t, 2, b, 4 * h, s=0.5)
    wh = torch.from_numpy(rs.uniform(-scale, scale, (2, h, 4 * h)).astype(
        np.float32)).to(dev, dt)
    c0, h0, d_hs = r(2, b, h, s=0.5), r(2, b, h, s=0.5), r(t, 2, b, h, s=0.1)
    fwd_tol, bwd_tol = TOL[dt]
    plan = cuda_lstm.launch_plan(dev, b, h, 2, dt, "lean")
    assert all(g > 1 for _, g in plan), plan
    args = (xp, wh, c0, h0, True)
    _, cs, acts = cuda_lstm.bilstm_scan_train_plain(*args)
    bargs = (d_hs, acts, cs, torch.cat([c0[None], cs[:-1]]), wh, True)
    for kernel, a, tol in ((cuda_lstm.bilstm_scan, args, fwd_tol),
                           (cuda_lstm.bilstm_scan_train, args, fwd_tol),
                           (cuda_lstm.bilstm_scan_bwd, bargs, bwd_tol)):
        got, one = kernel(*a), kernel(*a, groups=1)
        want = getattr(cuda_lstm, kernel.__name__ + "_plain")(*a)
        torch.cuda.synchronize()
        got, one, want = ((v,) if torch.is_tensor(v) else v
                          for v in (got, one, want))
        for g, o, w in zip(got, one, want):
            assert torch.equal(g, o), kernel.__name__
            _within(g, w, *tol)
