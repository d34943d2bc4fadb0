"""Do the float64 gradients of configs/tcn.json's and configs/dprnn.json's
train step jump under a tiny change of the input, in the JAX package as in
the port?  (The ANCHOR_AUX_LOSS question of ROADMAP.md, queue 3.)

    JAX_PLATFORMS=cpu python tools/anchor_aux_float64.py

Runs on the CPU in its own process (it turns on ``jax_enable_x64``): for
each file, at its keys as written (ANCHOR_AUX_LOSS 0.5, kmeans attractors,
RELU_LEAKAGE 0.3) and at ANCHOR_AUX_LOSS 0, one train step's loss and
gradients in float64 (COMPUTE_DTYPE and FLOATX float64, the JAX package's
'xla' scans and the port's plain ones) from the JAX package's seed-0 init,
(the depthwise convolutions' weights float32: the JAX package computes
that convolution in float32 at any activation dtype) carried into the port
with ``weights.from_jax``, on one toy batch (B=4,
T=128: uniform spectra from numpy seed 3, as the toy dataset draws them),
then on the same batch times (1 + 1e-13).  Prints, per package, how far the
gradients move (the worst share of a tensor's peak, and that tensor), and
how far the two packages' float64 gradients lie apart at the unchanged
input.
"""
import json
import os
import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import danet_tpu  # noqa: E402,F401  (registries)
from danet_tpu.hparams import hparams as jhp  # noqa: E402
from danet_tpu.models import DaNet as JaxDaNet  # noqa: E402
from danet_tpu.train.trainer import prepare_batch  # noqa: E402
from danet_tpu_torch import weights  # noqa: E402
from danet_tpu_torch.hparams import load_config  # noqa: E402

B, N, T = 4, 2, 128
MOVE = 1e-13


def _keys(name: str, aux) -> dict:
    with open(os.path.join(REPO, "configs", name)) as f:
        keys = json.load(f)
    keys.update(COMPUTE_DTYPE="float64", FLOATX="float64", BATCH_SIZE=B,
                LSTM_BACKEND="xla")
    if aux is not None:
        keys["ANCHOR_AUX_LOSS"] = aux
    return keys


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _share(a: dict, b: dict, names) -> tuple:
    """(worst max |a - b| / max |b| over the tensors, its name)."""
    return max((float(np.abs(_get(a, p) - _get(b, p)).max())
                / max(float(np.abs(_get(b, p)).max()), 1e-300), "/".join(p))
               for p in names)


def main():
    flat = np.random.RandomState(3).rand(B * N, T, 129)
    batch = prepare_batch(flat, B, N).astype(np.float64)
    for name in ("tcn.json", "dprnn.json"):
        for aux in (None, 0.0):
            keys = _keys(name, aux)
            jhp.load_json(os.path.join(REPO, "default.json"))
            jhp.load(keys)
            jhp.digest()
            jm = JaxDaNet()
            # the JAX package's depthwise convolution computes in float32
            # whatever the activations' dtype, and XLA's convolution takes
            # one dtype: its weights stay float32 (tcn-v1's only float32
            # step; the port computes it in float64)
            jp = jax.tree_util.tree_map_with_path(
                lambda path, v: jnp.asarray(v, jnp.float32 if [
                    getattr(k, "key", None) for k in path][-2:] == [
                        "dconv", "w"] else jnp.float64),
                jm.init(jax.random.PRNGKey(0)))
            grad_j = jax.jit(jax.grad(lambda p, x: jm.train_loss(p, x)[0]))
            tm = load_config(**keys).get_model()
            tm = tm(load_config(**keys))
            names = list(_paths(jax.device_get(jp)))

            def port_grads(x):
                params = weights.from_jax(jax.device_get(jp))
                leaves = [_get(params, p) for p in names]
                for v in leaves:
                    v.requires_grad_(True)
                loss, _ = tm.train_loss(params, torch.from_numpy(x))
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
                out = {}
                for p, v, g in zip(names, leaves, gs):
                    node = out
                    for k in p[:-1]:
                        node = node.setdefault(k, {})
                    node[p[-1]] = (np.zeros(v.shape) if g is None
                                   else g.detach().numpy())
                return out

            moved = batch * (1 + MOVE)
            g0 = jax.device_get(grad_j(jp, jnp.asarray(batch)))
            g1 = jax.device_get(grad_j(jp, jnp.asarray(moved)))
            p0, p1 = port_grads(batch), port_grads(moved)
            tag = "%s %s" % (name, "as written (ANCHOR_AUX_LOSS %s)" % (
                jhp.ANCHOR_AUX_LOSS,) if aux is None else
                "at ANCHOR_AUX_LOSS 0")
            print("%s, float64, B=%d T=%d: under a %g relative change of the "
                  "input the gradients move by %.3g of the peak (%s) in the "
                  "JAX package, %.3g (%s) in the port; the two packages "
                  "%.3g (%s) apart at the unchanged input"
                  % ((tag, B, T, MOVE) + _share(g1, g0, names)
                     + _share(p1, p0, names) + _share(p0, g0, names)))


if __name__ == "__main__":
    main()
