"""The weights of a run, made on the card from the seed.

The tree has the program's layout (nested dicts; an LSTM direction's
``wx`` [I, 4, H], ``wh`` [H, 4, H], ``b`` [4, H], gates candidate, input,
forget, output) with the scales of the repository's initialisation: U(-s,
s) for the matrices, the gate biases, unit layer-norm gains, normal
anchors.  All uniforms come from one draw of a ``torch.Generator`` on the
device and the anchors from a second, float32: the served type.  Both
sides get this same tree.
"""
from __future__ import annotations

import math

import torch


def _lstm(i: int, h: int, scale: float, bias: tuple) -> dict:
    return {"wx": ("u", (i, 4, h), scale), "wh": ("u", (h, 4, h), scale),
            "b": ("c", (4, h), bias)}


def _bilstm(i: int, h: int, scale: float, bias: tuple) -> dict:
    return {"fwd": _lstm(i, h, scale, bias), "bwd": _lstm(i, h, scale, bias)}


def _glorot(i: int, o: int) -> dict:
    return {"w": ("u", (i, o), math.sqrt(6.0 / (i + o))),
            "b": ("c", (o,), (0.0,))}


def spec(keys: dict, widths: dict) -> dict:
    """{path: (kind, shape, arg)} nested as the tree: kind 'u' uniform in
    +/- arg, 'c' constants ``arg`` repeated along the first axis, 'n'
    standard normal."""
    f = int(keys["FFT_SIZE"]) // 2 + 1
    e = int(keys["EMBED_SIZE"])
    kind = keys["ENCODER_TYPE"]
    if kind == "bilstm-orig":
        h, layers = int(widths["BILSTM_HIDDEN"]), int(widths["BILSTM_LAYERS"])
        enc, i = {}, f
        for k in range(layers):
            enc["lstm%d" % k] = _bilstm(i, h, 0.75 / math.sqrt(h),
                                        (0.0, 1.5, -1.0, 1.0))
            i = 2 * h
        enc["output"] = {"w": ("u", (i, f * e), 1.85)}
    elif kind == "dprnn-v1":
        d, h = int(keys["DPRNN_DIM"]), int(keys["DPRNN_HIDDEN"])
        enc = {"bottleneck": _glorot(f, d),
               "output": {"w": ("u", (d, f * e), 1.85)}}
        for k in range(int(keys["DPRNN_BLOCKS"])):
            ln = {"g": ("c", (d,), (1.0,)), "b": ("c", (d,), (0.0,))}
            enc["block%d" % k] = {
                "intra": _bilstm(d, h, 1.0 / math.sqrt(h), (0., 0., 1., 0.)),
                "intra_proj": _glorot(2 * h, d), "intra_ln": dict(ln),
                "inter": _bilstm(d, h, 1.0 / math.sqrt(h), (0., 0., 1., 0.)),
                "inter_proj": _glorot(2 * h, d), "inter_ln": dict(ln)}
    else:
        raise ValueError("no weights for ENCODER_TYPE %r" % kind)
    tree = {"encoder": enc, "train_estimator": {}, "separator": {}}
    if keys["INFER_ESTIMATOR_METHOD"] != keys["TRAIN_ESTIMATOR_METHOD"]:
        tree["infer_estimator"] = {
            "anchors": ("n", (int(keys["NUM_ANCHOR"]), e), None)}
    return tree


def _flat(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_flat(v) if isinstance(v, dict) else [v])
    return out


def make(keys: dict, widths: dict, seed: int, device) -> dict:
    """The seed's weights on ``device``: one uniform draw for every 'u'
    leaf and one normal draw for every 'n' leaf."""
    sp = spec(keys, widths)
    leaves = _flat(sp)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_u = sum(math.prod(s) for k, s, _ in leaves if k == "u")
    n_n = sum(math.prod(s) for k, s, _ in leaves if k == "n")
    uni = torch.rand(n_u, generator=gen, device=device)
    nor = torch.randn(max(n_n, 1), generator=gen, device=device)
    at = {"u": 0, "n": 0}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        kind, shape, arg = node
        if kind == "c":
            row = torch.tensor(arg, dtype=torch.float32, device=device)
            return row.reshape((-1,) + (1,) * (len(shape) - 1)).expand(
                shape).contiguous()
        n = math.prod(shape)
        src = uni if kind == "u" else nor
        x = src[at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        return (x * 2.0 - 1.0) * arg if kind == "u" else x.clone()

    return build(sp)
