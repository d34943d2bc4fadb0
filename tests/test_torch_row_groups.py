"""Row groups of the LSTM scan kernels (kernel B, kernel 2, kernel 3 and
their one-direction and state forms): the host's plan (``group_cap``,
``stacked_cap``, ``row_groups``, ``group_spans``, ``plan_launches``) for
a 132-SM card
against the shapes the models give the kernels, the kernels' own split of
the rows (``csrc/common.cuh::row_group``, compiled with the host's C++
compiler) against the plan's, and the launches as the wrappers make them,
recorded on the CPU with the launch replaced."""
import glob
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from danet_tpu_torch.ops.cuda import _build  # noqa: E402
from danet_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402

N_SM = 132                     # an H100 SXM's SMs
# the row ceilings of one group on an H100 at H=128 in float32 (227 KB of
# shared memory per block; the kernels' headers): kind -> rows
CEILING = {"lean": 5968, "save": 5168, "bwd": 885}
# their blocks per SM there at those shapes (registers): two of a forward,
# one of kernel 3
PER_SM = {"lean": 2, "save": 2, "bwd": 1}
KINDS = ("lean", "save", "bwd")
# the smallest ceiling on the main path: kernel 3 at H=600 (lstm-orig)
MAIN_CEILING = 256


def _plan(b, hdim, n_dirs, rows, per_sm=2):
    return cuda_lstm.plan_launches(b, rows, cuda_lstm.stacked_cap(
        b, hdim, n_dirs, N_SM, rows, lambda r: per_sm))


@pytest.mark.parametrize("b", [1, 32, 64, 100])
@pytest.mark.parametrize("hdim, n_dirs", [(300, 2), (600, 1)],
                         ids=["bilstm-orig", "lstm-orig"])
def test_torch_row_groups_main_path_one_group(b, hdim, n_dirs):
    """bilstm-orig's (38 x 2 = 76 blocks) and lstm-orig's (75) grids
    already fill a 132-SM card: one group, one launch, at B=1 (the tagged
    words), B=32 (one pass) and beyond, as before row groups."""
    assert cuda_lstm.group_cap(hdim, n_dirs, N_SM, 2) == 1
    assert _plan(b, hdim, n_dirs, MAIN_CEILING) == [(0, b, 1)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b, n_dirs, groups, launches", [
    (96, 2, (3, 3), 1), (2048, 2, (8, 4), 1), (4096, 2, (8, 4), {"bwd": 2}),
    (2048, 1, (16, 8), 1), (4096, 1, (16, 8), 1)],
    ids=["intra", "inter2048", "inter4096", "causal2048", "causal4096"])
def test_torch_row_groups_dprnn_shapes(kind, b, n_dirs, groups, launches):
    """dprnn-v1's scans (H=128: 16 blocks per direction) run in G > 1
    groups on a 132-SM card: the intra shape (T=64, B=96) one pass per
    group; the inter shapes (B=2048, 4096) as many copies of the blocks as
    the card holds, the forwards' two per SM (8 groups with two
    directions, 16 with one) and kernel 3's one (4, 8).  Kernel 3's
    885-row ceiling binds per group, so 2048 inter rows take one launch
    (three before row groups) and 4096 two."""
    plan = _plan(b, 128, n_dirs, CEILING[kind], PER_SM[kind])
    want = launches.get(kind, 1) if isinstance(launches, dict) else launches
    assert len(plan) == want
    g_want = groups[kind == "bwd"]
    assert all(g == g_want > 1 for _, _, g in plan)
    assert plan[0][0] == 0 and plan[-1][1] == b


@pytest.mark.parametrize("b", [33, 96, 2048, 4096, 20000])
def test_torch_row_groups_residency_read_at_a_groups_rows(b):
    """stacked_cap reads the blocks per SM at the rows of a group with one
    block per SM (4 groups at H=128 with two directions), or at the row
    ceiling when those pass it: the most any planned group holds, so the
    planned grid fits (more groups hold fewer rows)."""
    asked = []

    def residency(rows):
        asked.append(rows)
        return 2
    cap = cuda_lstm.stacked_cap(b, 128, 2, N_SM, 885, residency)
    assert cap == 8
    one = cuda_lstm.group_spans(b, cuda_lstm.row_groups(b, 4))
    assert asked == [min(885, max(hi - lo for lo, hi in one))]
    for lo, hi, g in cuda_lstm.plan_launches(b, 885, cap):
        assert max(h1 - l1 for l1, h1 in cuda_lstm.group_spans(hi - lo, g)) \
            <= asked[0]


@pytest.mark.parametrize("rows", [100, 885, 5968])
@pytest.mark.parametrize("cap", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("b", [1, 31, 33, 96, 100, 2048, 4096, 4097])
def test_torch_row_groups_cover_every_row_once(b, cap, rows):
    """Launches and their groups cover rows 0 .. B-1 once, in order; every
    group is non-empty, a whole number of 32-row passes but the last, and
    within the row ceiling; G is at most the cap and one pass per group."""
    nxt = 0
    for lo, hi, g in cuda_lstm.plan_launches(b, rows, cap):
        assert lo == nxt and hi > lo and 1 <= g <= min(cap, -(-(hi - lo)
                                                           // 32))
        nxt = hi
        spans = cuda_lstm.group_spans(hi - lo, g)
        assert len(spans) == g and spans[0][0] == 0 \
            and spans[-1][1] == hi - lo
        for (a0, a1), (c0, _) in zip(spans, spans[1:]):
            assert a1 == c0 and (a1 - a0) % 32 == 0
        assert all(a1 > a0 for a0, a1 in spans)
        assert max(a1 - a0 for a0, a1 in spans) <= rows
    assert nxt == b


def _c_row_group():
    """csrc/common.cuh's row_group and group_rows as a host program that
    prints, for each line "B G" of its input, the groups' [b0, b1) and the
    rows a block's shared memory holds."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = open(os.path.join(_build.CSRC, "common.cuh")).read()
    funcs = [re.search(r"__host__ __device__ __forceinline__ \w+ %s\(.*?\n}"
                       % name, text, re.S).group(0)
             for name in ("row_group", "group_rows")]
    src = ("#include <cstdio>\n#define __host__\n#define __device__\n"
           "#define __forceinline__ inline\n" + "\n".join(funcs) + """
int main() {
  int b, g;
  while (std::scanf("%d %d", &b, &g) == 2) {
    for (int i = 0; i < g; ++i) {
      int b0, b1;
      row_group(b, 32, g, i, &b0, &b1);
      std::printf("%d %d ", b0, b1);
    }
    std::printf("%d\\n", group_rows(b, 32, g));
  }
}
""")
    return cxx, src


def test_torch_row_groups_kernel_split_is_the_plans(tmp_path):
    """The kernels' own split (row_group, run by every block from B and
    grid.z) equals the host's group_spans, and their shared memory's rows
    (group_rows: ceil(P / G) passes, at most B) hold every group's, for
    every G up to one pass per group, at batches from 2 to 4097."""
    cxx, src = _c_row_group()
    (tmp_path / "rg.cc").write_text(src)
    exe = str(tmp_path / "rg")
    subprocess.run([cxx, "-O1", "-o", exe, str(tmp_path / "rg.cc")],
                   check=True)
    cases = [(b, g) for b in (2, 31, 33, 64, 65, 96, 100, 2048, 2049, 4097)
             for g in range(1, min(-(-b // 32), 16) + 1)]
    out = subprocess.run([exe], input="".join("%d %d\n" % c for c in cases),
                         capture_output=True, text=True, check=True).stdout
    for (b, g), line in zip(cases, out.splitlines()):
        vals = [int(v) for v in line.split()]
        spans = cuda_lstm.group_spans(b, g)
        assert [tuple(vals[2 * i:2 * i + 2]) for i in range(g)] == spans
        assert vals[-1] == min(b, -(-(-(-b // 32)) // g) * 32) \
            >= max(hi - lo for lo, hi in spans)


def _c_arg_names(entry: str) -> list:
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        found = re.search(r'extern "C" int %s\(([^)]*)\)' % entry,
                          open(path).read())
        if found:
            return [a.strip().rsplit(" ", 1)[1].lstrip("*")
                    for a in found.group(1).split(",")]
    raise AssertionError("no extern \"C\" %s in csrc" % entry)


def _inputs(t, b, h, n_dirs):
    rs = np.random.RandomState(b + n_dirs)
    d = (2,) if n_dirs == 2 else ()

    def r(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))
    xp, wh = r(t, *d, b, 4 * h), r(*d, h, 4 * h) * 0.1
    c0, h0, d_hs = r(*d, b, h), r(*d, b, h), r(t, *d, b, h)
    return xp, wh, c0, h0, d_hs


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers as on a 132-SM card with the H100's row ceilings and
    residency, each launch recorded (entry, tensors, ints)."""
    calls = []
    monkeypatch.setattr(cuda_lstm, "_on_cuda", lambda x, what: True)
    monkeypatch.setattr(
        cuda_lstm, "_group_cap",
        lambda device, b, h, d, dtype, kind, rows, groups:
        groups if groups is not None else cuda_lstm.stacked_cap(
            b, h, d, N_SM, rows, lambda r: PER_SM[kind]))
    monkeypatch.setattr(cuda_lstm, "max_rows",
                        lambda device, h, dtype, kind: CEILING[kind])
    monkeypatch.setattr(cuda_lstm, "_launch",
                        lambda entry, what, device, tensors, ints:
                        calls.append((entry, tensors, ints)))
    return calls


@pytest.mark.parametrize("groups", [None, 1])
@pytest.mark.parametrize("n_dirs, b, planned", [(2, 96, 3), (1, 96, 3),
                                                (2, 2048, 8), (1, 64, 2)])
def test_torch_row_groups_forward_launch(on_card, n_dirs, b, planned,
                                         groups):
    """Every forward (lean, saving, the state entries) passes G as its
    last int, after (T, B, H, dtype, tanh_cand), and its exchange scratch
    of [2, D, B, H] int64 words, which holds the [D, G, ceil(H / 8)]
    flags; groups=1 launches G = 1 over the same rows."""
    t, h = 2, 128
    xp, wh, c0, h0, _ = _inputs(t, b, h, n_dirs)
    g = planned if groups is None else 1
    pre = "bi" if n_dirs == 2 else ""
    calls = [("%slstm_scan" % pre, ()), ("%slstm_scan_train" % pre, ())]
    if n_dirs == 1:
        calls += [("lstm_scan_train_state", ()), ("lstm_scan", (True,))]
    for name, extra in calls:
        c0_ = c0 if "state" not in name and not extra else c0.float()
        getattr(cuda_lstm, name)(xp, wh, c0_, h0, True, *extra,
                                 groups=groups)
    assert len(on_card) == len(calls)
    for (entry, tensors, ints), (name, extra) in zip(on_card, calls):
        assert entry == "danet_" + name + ("_state" if extra else "")
        names = _c_arg_names(entry)
        assert names[len(tensors):] == ["n_steps", "batch", "hdim", "dtype",
                                        "tanh_cand", "groups", "stream"]
        assert tuple(ints) == (t, b, h, 0, 1, g)
        xch = dict(zip(names, tensors))["xch"]
        assert xch.dtype == torch.int64 and xch.is_contiguous()
        assert tuple(xch.shape) == (2, n_dirs, b, h)
        assert xch.numel() * 2 >= n_dirs * g * -(-h // 8)


@pytest.mark.parametrize("groups", [None, 1])
@pytest.mark.parametrize("entry, n_dirs, b, planned", [
    ("bilstm_scan_bwd", 2, 96, 3), ("bilstm_scan_bwd", 2, 2048, 4),
    ("lstm_scan_bwd", 1, 96, 3), ("lstm_scan_bwd", 1, 4096, 8),
    ("lstm_scan_bwd_seeded", 1, 96, 3), ("lstm_scan_bwd_seeded", 1, 2048,
                                         8)])
def test_torch_row_groups_backward_launch(on_card, entry, n_dirs, b,
                                          planned, groups):
    """Kernel 3 (and its seeded form) passes its inputs and outputs (dc_T
    last in the seeded form), then (T, B, H, dtype, tanh_cand, G); 2,048
    and 4,096 rows at H=128 take one launch, and with groups=1 the 885-row
    ceiling of one group splits them, each launch of G = 1."""
    t, h = 2, 128
    _, wh, c0, _, d_hs = _inputs(t, b, h, n_dirs)
    acts = torch.randn(d_hs.shape[:-1] + (4 * h,))
    cs, c_prev = torch.randn_like(d_hs), torch.randn_like(d_hs)
    seeded = entry.endswith("seeded")
    getattr(cuda_lstm, entry)(d_hs, acts, cs, c_prev, wh, True,
                              *((c0,) if seeded else ()), groups=groups)
    entry = "danet_" + entry
    want = [(b, planned)] if groups is None else [
        (hi - lo, 1) for lo, hi in cuda_lstm._spans(b, 885)]
    assert [(ints[1], ints[5]) for _, _, ints in on_card] == want
    names = _c_arg_names(entry)
    for e, tensors, ints in on_card:
        assert e == entry
        assert names[len(tensors):] == ["n_steps", "batch", "hdim", "dtype",
                                        "tanh_cand", "groups", "stream"]
        args = dict(zip(names, tensors))
        assert list(args)[-1] == ("dc_T" if seeded else "dh0")
        assert args["dxp"].shape[-2] == ints[1]
        assert tuple(ints[:5]) == (t, ints[1], h, 0, 1)


def test_torch_row_groups_off_the_card_one_group():
    """Off the card the plan has one group (no kernel launches there), and
    an explicit ``groups`` is a cap: never more than one pass per group."""
    assert cuda_lstm._group_cap("cpu", 96, 128, 2, torch.float32, "lean",
                                0, None) == 1
    assert cuda_lstm._group_cap("cpu", 96, 128, 2, torch.float32, "lean",
                                0, 4) == 4
    assert cuda_lstm.row_groups(96, 16) == 3
    assert cuda_lstm.row_groups(32, 16) == 1
    assert cuda_lstm.row_groups(1, 16) == 1
    assert cuda_lstm.launch_plan("cpu", 4096, 128, 2, torch.float32,
                                 "bwd") == [(4096, 1)]
