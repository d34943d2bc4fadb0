"""Encoders: ``toy``, ``lstm-orig``, ``bilstm-orig``, ``gru-v1``,
``attn-v1``, ``moe-v1``, ``tcn-v1``, ``dprnn-v1``, ``conv-bilstm-v1`` and
the LSTM output head.

Counterpart of ``danet_tpu/models/encoders.py:25-63,67-1251``: the
single-device paths and tensor, pipeline, expert and sequence parallelism,
with the causal streaming hooks of ``lstm-orig``,
``gru-v1``, causal ``attn-v1`` and ``moe-v1``, causal ``tcn-v1`` and
online ``dprnn-v1``: ``stream_state_init(batch, dtype, device)`` (the
state at a fresh stream), ``stream_hidden(params, x, state)`` (a centred
chunk [B, Tc, F] -> (hidden [B, Tc, .], new state); chunks fed back to
back reproduce the offline forward) and ``stream_head(params, h, mu)``
(the head with a frozen centring statistic).  On the card the hooks run
the same hand kernels as the offline path (JAX pins its plain scan
there): the LSTMs carry c in float32, the kernel's own carry.
``bilstm-orig`` drops out after every layer in training, ``attn-v1``
after every block's MLP, ``tcn-v1`` after every block, ``dprnn-v1``
after each path of a block and ``conv-bilstm-v1`` after each BiLSTM;
``lstm-orig`` and ``gru-v1`` do not, because their JAX ``apply`` ignores
``train``.  REMAT rematerialises the layers of ``lstm-orig`` and
``bilstm-orig`` and the blocks of ``tcn-v1`` and ``dprnn-v1`` in the
backward (``_maybe_remat``), where JAX's dense paths call
``_maybe_remat``.  ``HDIM`` and ``N_LAYERS`` are class attributes of the
recurrent encoders, as in the JAX package, so tests can narrow both
packages the same way; ``attn-v1``, ``tcn-v1`` and ``dprnn-v1`` read
their widths from their keys.

Under data and tensor parallelism (MESH_DATA, MESH_MODEL) every encoder
runs its single-device code on the rank's rows with the full weights,
which the trainer gathers once per step (``parallel/sharding.py``):
``bilstm-orig`` through ``rnn.bilstm_apply_tp`` (its TP kernel route),
the others as they are, each with its hand kernels on a card.  ATTN_BACKEND
'auto' stays the dense attention under MESH_MODEL, as in JAX
(``danet_tpu/ops/pallas/attention.py:55-70``).  Under MESH_PIPE
``bilstm-orig``'s stack runs GPipe microbatches over the 'pipe' axis
(``parallel/pipeline.py``, each stage's layers on the hand kernels), and
under MESH_EXPERT ``moe-v1``'s MLPs run expert-parallel
(``parallel/expert.py``), each where ``_route_mesh`` finds the axis.
Under MESH_SEQ the recurrent stacks of ``bilstm-orig`` and ``gru-v1`` run
on this rank's T-chunk of its rows (``parallel/seq_parallel.py``:
SP_RNN_SCHEME 'relay' or 'halo', SP_HALO) and their output is gathered
over 'seq' before the head, and the attention of ``attn-v1`` and
``moe-v1`` runs T-split (SP_ATTN 'ring' or 'ulysses',
``parallel/ring_attention.py``, ``parallel/ulysses.py``), the rest of the
encoder alike on every rank of the 'seq' group, as JAX's GSPMD runs it
around its ``shard_map``s.  ``tcn-v1``'s blocks and ``dprnn-v1``'s
bottleneck and blocks run on the rank's chunk too (``tcn_stack_sp``: the
convolutions' halos; ``dprnn_stack_sp``: whole segments, two all-to-alls
per block), gathered before the head, and ``conv-bilstm-v1`` runs whole on
the chunk (``conv_bilstm_sp``), gathered after its head.  ``SEQ_LEAVES``
names the leaves each rank differentiates from its chunk alone.
"""
from __future__ import annotations

from math import sqrt

import numpy as np
import torch
import torch.utils.checkpoint

from danet_tpu_torch.hparams import hparams
from danet_tpu_torch.models.base import Encoder
from danet_tpu_torch.ops import local_attention, nn, rnn
from danet_tpu_torch.ops.cuda import attention
from danet_tpu_torch.parallel import expert


def _candidate_activation(hp) -> str:
    """'linear' reproduces the reference's no-tanh candidate cell
    (LSTM_LEGACY_CELL); the default is 'tanh'."""
    return "linear" if getattr(hp, "LSTM_LEGACY_CELL", False) else "tanh"


def _backend(hp) -> str:
    """LSTM_BACKEND: 'auto' and 'pallas' take the hand kernels on CUDA."""
    return getattr(hp, "LSTM_BACKEND", "auto") or "auto"


def _centered(log_spectra):
    return log_spectra - torch.mean(log_spectra, dim=(1, 2), keepdim=True)


def _carry_dtype(dtype) -> torch.dtype:
    """The dtype the LSTM streams carry c in: float32, or float64 for a
    float64 run of the plain path."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _maybe_remat(hp, fn):
    """REMAT=true: ``fn`` under ``torch.utils.checkpoint`` whenever
    autograd records, so that its activations are recomputed in the
    backward instead of stored.  Non-reentrant, so that the recompute
    runs the same (saving) kernels as the first forward: a REMAT step
    launches each layer's saving forward twice and its backward once,
    also in the K-step CUDA graph.  No RNG state is kept, because no
    region reads a default generator: dropout stays outside the region,
    or its masks are drawn before it and passed in."""
    if not bool(getattr(hp, "REMAT", False)):
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def _route_mesh(hp, axis: str, n: int):
    """The active mesh (``parallel/sharding.py``) when it carries ``axis``
    at size ``n``, else None.  The Trainer registers its mesh, which
    carries the configured axes, so training routes as configured; on a
    host whose processes cannot hold the configured mesh (a MESH_* training
    config serving on one card) the model runs densely.  Only
    ``MeshUnavailableError`` routes dense: any other error of the mesh's
    construction is a bug and propagates."""
    from danet_tpu_torch.parallel import sharding
    try:
        mesh = sharding.active_mesh(hp)
    except sharding.MeshUnavailableError:
        return None
    if mesh.shape.get(axis) == n:
        return mesh
    return None


def _rows_mesh():
    """The trainer's registered mesh when its batches split into more
    than one row slice (a routed MoE's capacity then counts the global
    batch), else None."""
    from danet_tpu_torch.parallel import sharding
    mesh = sharding.registered_mesh()
    if mesh is None or mesh.coords is None or \
            sharding.row_slices(mesh) <= 1:
        return None
    return mesh


def _int_key(hp, key: str, default: int) -> int:
    """An integer width key, ``default`` when absent or null."""
    v = getattr(hp, key, None)
    return default if v is None else int(v)


@hparams.register_encoder("toy")
class ToyEncoder(Encoder):
    """3-layer MLP for debugging (the default.json encoder)."""

    def init(self, generator, device=None):
        hp = self.hp
        return {
            "linear0": nn.linear_init(generator, hp.FEATURE_SIZE,
                                      hp.FFT_SIZE * 2, device=device),
            "linear1": nn.linear_init(generator, hp.FFT_SIZE * 2,
                                      hp.FEATURE_SIZE * hp.EMBED_SIZE,
                                      device=device),
        }

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        hp = self.hp
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        mid = nn.leaky_relu(nn.linear_apply(params["linear0"], log_spectra),
                            hp.RELU_LEAKAGE)
        if tap:
            tap("mid_act", mid)
        out = nn.linear_apply(params["linear1"], mid)
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)


class _LstmHead:
    """Output head: mean-center + bias-free linear to F*E + reshape."""

    @staticmethod
    def init(generator, hp, in_dim, device=None):
        return nn.linear_init(generator, in_dim,
                              hp.FEATURE_SIZE * hp.EMBED_SIZE,
                              w_scale=1.85, bias=False, device=device)

    @staticmethod
    def apply_centered(params, hp, x, mu):
        """The head with an explicit centring statistic ``mu`` (streaming
        freezes it from the warm-up window)."""
        x = x - mu
        out = nn.linear_apply(params, x)
        return out.reshape(x.shape[0], x.shape[1], hp.FEATURE_SIZE,
                           hp.EMBED_SIZE)

    @staticmethod
    def apply(params, hp, x):
        return _LstmHead.apply_centered(
            params, hp, x, torch.mean(x, dim=(1, 2), keepdim=True))


@hparams.register_encoder("lstm-orig")
class LstmEncoder(Encoder):
    """4x unidirectional LSTM, 600 units (reference modules.py:140-196)."""

    HDIM = 600
    N_LAYERS = 4

    def init(self, generator, device=None):
        hp = self.hp
        w_scale = 1.15 / sqrt(self.HDIM)
        gate_bias = (0.0, 1.5, -1.0, 1.0)
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"lstm{i}"] = rnn.lstm_init(
                generator, in_dim, self.HDIM, w_scale, gate_bias, device)
            in_dim = self.HDIM
        params["output"] = _LstmHead.init(generator, hp, in_dim, device)
        return params

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; no dropout (``train`` is ignored);
        taps ``lstm<i>_h``."""
        hp = self.hp
        act = _candidate_activation(hp)
        layer = _maybe_remat(hp, lambda p, v: rnn.lstm_apply(
            p, v, act, backend=_backend(hp)))
        x = _centered(log_spectra)
        for i in range(self.N_LAYERS):
            x = layer(params[f"lstm{i}"], x)
            if tap:
                tap("lstm%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)

    def stream_state_init(self, batch: int, dtype=torch.float32,
                          device=None):
        """Per-layer (c, h) at a fresh stream: zeros, c in float32."""
        h = torch.zeros((batch, self.HDIM), dtype=dtype, device=device)
        c = h.to(_carry_dtype(dtype))
        return [(c, h) for _ in range(self.N_LAYERS)]

    def stream_hidden(self, params, x, state):
        """Centred chunk [B, Tc, F] -> (hidden [B, Tc, H], new state): each
        layer's scan (kernel B on the card) resumes from its carry."""
        act = _candidate_activation(self.hp)
        new_state = []
        for i in range(self.N_LAYERS):
            c0, h0 = state[i]
            x, carry = rnn.lstm_apply(params[f"lstm{i}"], x, act, c0=c0,
                                      h0=h0, backend=_backend(self.hp),
                                      return_state=True)
            new_state.append(carry)
        return x, new_state

    def stream_head(self, params, h, mu):
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


@hparams.register_encoder("bilstm-orig")
class BiLstmEncoder(Encoder):
    """4x BiLSTM, 300 units per direction -- the paper architecture."""

    HDIM = 300
    N_LAYERS = 4
    SEQ_LEAVES = r"lstm\d+/"

    def init(self, generator, device=None):
        hp = self.hp
        w_scale = 0.75 / sqrt(self.HDIM)
        gate_bias = (0.0, 1.5, -1.0, 1.0)
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"lstm{i}"] = rnn.bilstm_init(
                generator, in_dim, self.HDIM, w_scale, gate_bias, device)
            in_dim = self.HDIM * 2
        params["output"] = _LstmHead.init(generator, hp, in_dim, device)
        return params

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB after every layer, drawn from ``generator``;
        taps ``lstm<i>_h``.  Under MESH_PIPE > 1 with a mesh that has the
        'pipe' axis, the stack runs pipelined (``_apply_pipelined``: no
        taps, as in JAX); under MESH_SEQ > 1 with a 'seq' axis,
        sequence-parallel (``_apply_sp``: no taps)."""
        hp = self.hp
        act = _candidate_activation(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        x = _centered(log_spectra)
        n_pipe = int(getattr(hp, "MESH_PIPE", 1) or 1)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        pipe_mesh = _route_mesh(hp, "pipe", n_pipe) if n_pipe > 1 else None
        seq_mesh = (_route_mesh(hp, "seq", n_seq)
                    if n_seq > 1 and pipe_mesh is None else None)
        if pipe_mesh is not None:
            x = self._apply_pipelined(params, x, pipe_mesh, n_pipe, act, keep,
                                      generator)
            return _LstmHead.apply(params["output"], hp, x)
        if seq_mesh is not None:
            x = self._apply_sp(params, x, seq_mesh, n_seq, act, keep,
                               generator)
            return _LstmHead.apply(params["output"], hp, x)
        tp_mesh = self._tp_kernel_mesh()
        # the dropout that ends each layer stays outside the region, and
        # outside the rank's share under tensor parallelism
        if tp_mesh is not None:
            layer = _maybe_remat(hp, lambda p, v: rnn.bilstm_apply_tp(
                p, v, tp_mesh, act))
        else:
            layer = _maybe_remat(hp, lambda p, v: rnn.bilstm_apply(
                p, v, act, backend=_backend(hp)))
        for i in range(self.N_LAYERS):
            x = layer(params[f"lstm{i}"], x)
            if generator is not None:
                x = nn.dropout(generator, x, keep)
            if tap:
                tap("lstm%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)

    def _apply_sp(self, params, x, mesh, n_seq, act, keep, generator):
        """The stack through ``parallel/seq_parallel.py`` on this rank's
        T-chunk (SP_RNN_SCHEME, the halo min(SP_HALO or 32, T / S)), its
        output gathered over 'seq' (JAX ``_apply_sp``,
        ``danet_tpu/models/encoders.py:277-293``)."""
        from danet_tpu_torch.parallel import collectives, seq_parallel
        hp = self.hp
        t = x.shape[1]
        if t % n_seq:
            raise ValueError(
                "MESH_SEQ=%d must divide the frame count T=%d (pick "
                "MAX_TRAIN_LEN / TIME_BUCKET accordingly)" % (n_seq, t))
        halo = min(int(getattr(hp, "SP_HALO", 0) or 32), t // n_seq)
        layers = [params[f"lstm{i}"] for i in range(self.N_LAYERS)]
        h = seq_parallel.bilstm_stack_sp(
            layers, x, mesh, halo=halo, candidate_activation=act,
            backend=_backend(hp), data_axis=None, dropout_rng=generator,
            keep_prob=keep, remat=bool(getattr(hp, "REMAT", False)),
            scheme=getattr(hp, "SP_RNN_SCHEME", "relay") or "relay")
        return collectives.leave_gather(mesh, h, "seq", 1)

    def _apply_pipelined(self, params, x, mesh, n_pipe, act, keep,
                         generator):
        """The stack through ``parallel/pipeline.py`` on the mesh's 'pipe'
        axis: PIPE_MICROBATCHES microbatches, or (0) JAX's default, as
        many as keep the bubble small, 2 S, clipped to a divisor of the
        global batch (this rank's rows times the mesh's row slices)."""
        from danet_tpu_torch.parallel import pipeline, sharding
        hp = self.hp
        layers = [params[f"lstm{i}"] for i in range(self.N_LAYERS)]
        b = x.shape[0] * sharding.row_slices(mesh)
        n_micro = int(getattr(hp, "PIPE_MICROBATCHES", 0) or 0)
        if not n_micro:
            n_micro = min(b, 2 * n_pipe)
            while b % n_micro:
                n_micro -= 1
        if b % n_micro:
            raise AssertionError("the batch %d must divide into %d "
                                 "microbatches" % (b, n_micro))
        return pipeline.bilstm_stack_pipelined(
            layers, x, mesh, n_micro=n_micro, candidate_activation=act,
            backend=_backend(hp), dropout_rng=generator, keep_prob=keep,
            remat=bool(getattr(hp, "REMAT", False)))

    def _tp_kernel_mesh(self):
        """The mesh of the tensor-parallel kernel route
        (``rnn.bilstm_apply_tp``: this rank's rows, the full weights, the
        hand kernels), or None where the plain per-backend path applies:
        no MESH_MODEL > 1, an explicit LSTM_BACKEND other than 'auto' or
        'pallas', or no mesh with that 'model' axis (``_route_mesh``)."""
        hp = self.hp
        n = int(getattr(hp, "MESH_MODEL", 1) or 1)
        if n <= 1 or _backend(hp) not in ("auto", "pallas"):
            return None
        return _route_mesh(hp, "model", n)


@hparams.register_encoder("gru-v1")
class GruEncoder(Encoder):
    """4x unidirectional GRU, 600 units; the same centering and head as
    the LSTM encoders.  Under MESH_SEQ > 1 with a 'seq' axis the stack runs
    sequence-parallel (``parallel/seq_parallel.gru_stack_sp``), its output
    gathered over 'seq' before the head."""

    HDIM = 600
    N_LAYERS = 4
    SEQ_LEAVES = r"gru\d+/"

    def init(self, generator, device=None):
        hp = self.hp
        w_scale = 0.1 / sqrt(self.HDIM)  # reference main.py:175
        params = {}
        in_dim = hp.FEATURE_SIZE
        for i in range(self.N_LAYERS):
            params[f"gru{i}"] = rnn.gru_init(generator, in_dim, self.HDIM,
                                             w_scale, device)
            in_dim = self.HDIM
        params["output"] = _LstmHead.init(generator, hp, in_dim, device)
        return params

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; no dropout (``train`` is ignored);
        taps ``gru<i>_h`` (none under MESH_SEQ; JAX
        ``danet_tpu/models/encoders.py:700-718``)."""
        hp = self.hp
        x = _centered(log_spectra)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        mesh = _route_mesh(hp, "seq", n_seq) if n_seq > 1 else None
        if mesh is not None:
            from danet_tpu_torch.parallel import collectives, seq_parallel
            t = x.shape[1]
            if t % n_seq:
                raise ValueError(
                    "MESH_SEQ=%d must divide the frame count T=%d"
                    % (n_seq, t))
            halo = min(int(getattr(hp, "SP_HALO", 0) or 32), t // n_seq)
            layers = [params[f"gru{i}"] for i in range(self.N_LAYERS)]
            h = seq_parallel.gru_stack_sp(
                layers, x, mesh, halo=halo, backend=_backend(hp),
                data_axis=None, remat=bool(getattr(hp, "REMAT", False)),
                scheme=getattr(hp, "SP_RNN_SCHEME", "relay") or "relay")
            x = collectives.leave_gather(mesh, h, "seq", 1)
            return _LstmHead.apply(params["output"], hp, x)
        for i in range(self.N_LAYERS):
            x = rnn.gru_apply(params[f"gru{i}"], x, backend=_backend(hp))
            if tap:
                tap("gru%d_h" % i, x)
        return _LstmHead.apply(params["output"], hp, x)

    def stream_state_init(self, batch: int, dtype=torch.float32,
                          device=None):
        z = torch.zeros((batch, self.HDIM), dtype=dtype, device=device)
        return [z for _ in range(self.N_LAYERS)]

    def stream_hidden(self, params, x, state):
        """Each layer's scan (kernel 4f on the card) resumes from its c."""
        new_state = []
        for i in range(self.N_LAYERS):
            x, c = rnn.gru_apply(params[f"gru{i}"], x, c0=state[i],
                                 backend=_backend(self.hp),
                                 return_state=True)
            new_state.append(c)
        return x, new_state

    def stream_head(self, params, h, mu):
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


def _posenc_denominators(d: int) -> np.ndarray:
    """10000 ** (2 i / d) for i < d / 2, float64: the sinusoidal positions'
    wavelengths over 2 pi."""
    return 10000.0 ** (2 * np.arange(d // 2) / d)


@hparams.register_encoder("attn-v1")
class AttentionEncoder(Encoder):
    """Pre-LN transformer encoder over frames (not in the reference).

    ATTN_DIM, ATTN_HEADS, ATTN_LAYERS, ATTN_MLP_MULT set the widths;
    ATTN_BACKEND picks the attention: 'flash' the flash kernels
    (``ops/cuda/attention.py``, T a multiple of 128), 'auto' and 'xla' the
    dense attention in plain PyTorch.  ATTN_CAUSAL limits each frame's
    attention to itself and the ATTN_LOOKBACK - 1 frames before it, and
    is read before ATTN_BACKEND, as in the JAX package: the band runs
    chunked or dense by ATTN_LOCAL_CHUNK (``ops/local_attention.py``),
    never on the flash kernels, which have no band.  Under ATTN_CAUSAL
    the encoder streams: each block keeps a rolling K/V cache of the last
    ATTN_LOOKBACK - 1 frames.  Under MESH_SEQ > 1 with a 'seq' axis the
    attention runs T-split over it (``_sp_attn_fn``: SP_ATTN 'ring' or
    'ulysses', the band in global positions), and ``apply`` takes an
    external ``attn_fn`` (``DaNet.separate_sp``) with JAX's guard against
    one that would drop the band."""

    def _dims(self):
        hp = self.hp
        d = _int_key(hp, "ATTN_DIM", 256)
        heads = _int_key(hp, "ATTN_HEADS", 4)
        if d % 2 != 0:
            raise ValueError("ATTN_DIM must be even (got %d)" % d)
        if d % heads != 0:
            raise ValueError(
                "ATTN_DIM (%d) must divide by ATTN_HEADS (%d)" % (d, heads))
        return (d, heads, _int_key(hp, "ATTN_LAYERS", 4),
                _int_key(hp, "ATTN_MLP_MULT", 4))

    def init(self, generator, device=None):
        hp = self.hp
        d, _, n_layers, mlp = self._dims()
        params = {
            "embed": nn.linear_init(generator, hp.FEATURE_SIZE, d,
                                    device=device),
            "output": nn.linear_init(generator, d,
                                     hp.FEATURE_SIZE * hp.EMBED_SIZE,
                                     bias=False, device=device),
        }
        for i in range(n_layers):
            params[f"block{i}"] = {
                "qkv": nn.linear_init(generator, d, 3 * d, device=device),
                "proj": nn.linear_init(generator, d, d, device=device),
                "ln1": {"g": torch.ones(d, device=device),
                        "b": torch.zeros(d, device=device)},
                "ln2": {"g": torch.ones(d, device=device),
                        "b": torch.zeros(d, device=device)},
                **self._mlp_params(generator, d, mlp, device),
            }
        return params

    def _mlp_params(self, generator, d, mlp, device=None):
        return {"mlp_in": nn.linear_init(generator, d, mlp * d,
                                         device=device),
                "mlp_out": nn.linear_init(generator, mlp * d, d,
                                          device=device)}

    def _mlp(self, blk, y, train=False):
        return nn.linear_apply(blk["mlp_out"], nn.gelu(
            nn.linear_apply(blk["mlp_in"], y)))

    @staticmethod
    def _posenc(t, d, dtype, device, offset=0):
        """Sinusoidal positions offset .. offset + t - 1, [t, d] in
        ``dtype``: angles and sines in float64 on ``device``, rounded to
        float32 first, as the JAX package's numpy table.  ``offset`` may be
        a tensor on ``device`` (a stream's frame count: no host read).
        Built on each call (it depends on t); only the wavelengths are
        cached.  The JAX package's streaming positions (``_posenc_dyn``)
        compute in float32; these are the offline table's at every
        offset, so a stream reproduces the offline forward."""
        den = nn.device_constant(("posenc-denominators", d),
                                 lambda: _posenc_denominators(d), device)
        pos = torch.arange(t, dtype=torch.float64, device=device) + offset
        ang = pos[:, None] / den[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return pe.float().to(dtype)

    @staticmethod
    def _dense_attention(q, k, v, key_mask, band=None):
        """Full masked multi-head attention: q, k, v [B, T, H, D], key_mask
        [B, T] bool -> [B, T, H, D]; ``band`` [T, T] bool, if given, masks
        the keys outside each query's causal window too.  Logits in q's
        dtype, masked keys at -1e9 and the softmax in float32, as XLA runs
        the JAX package's."""
        hd = q.shape[-1]
        logits = nn.ee("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
            torch.full((), hd, dtype=q.dtype, device=q.device))
        mask = key_mask[:, None, None, :]
        if band is not None:
            mask = mask & band[None, None]
        logits = torch.where(mask, logits.float(),
                             torch.full((), -1e9, dtype=torch.float32,
                                        device=q.device))
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
        return nn.ee("bhqk,bkhd->bqhd", attn, v)

    def _causal_window(self):
        """ATTN_LOOKBACK frames (the query included) under ATTN_CAUSAL, else
        0; an explicit ATTN_LOOKBACK below 1 raises ValueError."""
        if not bool(getattr(self.hp, "ATTN_CAUSAL", False)):
            return 0
        w = _int_key(self.hp, "ATTN_LOOKBACK", 128)
        if w < 1:
            raise ValueError("ATTN_LOOKBACK must be >= 1 (got %d)" % w)
        return w

    def _sp_attn_fn(self, mesh, causal_window: int = 0):
        """The sequence-parallel attention of SP_ATTN ('ring' by default,
        or 'ulysses') over ``mesh``'s 'seq' axis, as attn_fn(q, k, v,
        key_mask), on the rows as they are (the trainer split them; JAX
        ``_sp_attn_fn``)."""
        kind = str(getattr(self.hp, "SP_ATTN", None) or "ring")
        if kind == "ulysses":
            from danet_tpu_torch.parallel.ulysses import (
                ulysses_attention as sp_attention)
        elif kind == "ring":
            from danet_tpu_torch.parallel.ring_attention import (
                ring_attention as sp_attention)
        else:
            raise ValueError("SP_ATTN must be 'ring' or 'ulysses', got %r"
                             % (kind,))
        return lambda q, k, v, km: sp_attention(
            q, k, v, mesh, key_mask=km, data_axis=None,
            causal_window=causal_window)

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None, attn_fn=None, attn_fn_is_causal=False):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB on every block's MLP output, drawn from
        ``generator``; taps ``block<i>_h``.  ``attn_fn(q, k, v, key_mask)
        -> [B, T, H, D]`` replaces the attention (``DaNet.separate_sp``'s
        sequence-parallel one); ``attn_fn_is_causal``: it applies the
        ATTN_CAUSAL band itself, else ATTN_CAUSAL with an ``attn_fn``
        raises ValueError (JAX's guard)."""
        hp = self.hp
        d, heads, n_layers, _ = self._dims()
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop = generator is not None and keep < 1.0
        causal_w = self._causal_window()
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        if causal_w and attn_fn is not None and not attn_fn_is_causal:
            raise ValueError(
                "ATTN_CAUSAL with an external attn_fn would silently "
                "drop the causal band; pass causal_window to the SP "
                "attention and set attn_fn_is_causal=True "
                "(DaNet.separate_sp does)")
        seq_mesh = (_route_mesh(hp, "seq", n_seq)
                    if attn_fn is None and n_seq > 1 else None)
        if seq_mesh is not None:
            attn_fn = self._sp_attn_fn(seq_mesh, causal_window=causal_w)
        elif attn_fn is None and causal_w:
            # the band, chunked or dense, whatever ATTN_BACKEND says
            attn_fn = local_attention.resolve_banded_attn_fn(
                hp, t, causal_w, self._dense_attention, log_spectra.device)
        elif attn_fn is None:
            attn_fn = attention.resolve_attn_fn(hp, t, self._dense_attention)

        # zero-padded frames have exactly zero spectra: they are no keys,
        # and they do not shift the mean of the real frames
        key_mask = torch.any(log_spectra != 0.0, dim=-1)       # [B, T]
        mcount = torch.sum(key_mask, dim=1)[:, None, None]
        # JAX's weakly typed float32 denominator takes the spectra's dtype
        den = (mcount * log_spectra.shape[-1] + 1e-6).to(log_spectra.dtype)
        mu = torch.sum(log_spectra * key_mask[..., None], dim=(1, 2),
                       keepdim=True) / den
        x = (log_spectra - mu) * key_mask[..., None].to(log_spectra.dtype)
        h = nn.linear_apply(params["embed"], x)
        h = h + self._posenc(t, d, h.dtype, h.device)
        for i in range(n_layers):
            p = params[f"block{i}"]
            y = nn.layer_norm(p["ln1"], h)
            qkv = nn.linear_apply(p["qkv"], y).reshape(b, t, 3, heads,
                                                       d // heads)
            o = attn_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], key_mask)
            h = h + nn.linear_apply(p["proj"], o.reshape(b, t, d))
            y = self._mlp(p, nn.layer_norm(p["ln2"], h), train=train)
            if drop:
                y = nn.dropout(generator, y, keep)
            h = h + y
            if tap:
                tap("block%d_h" % i, h)
        out = nn.linear_apply(params["output"], h)
        return out.reshape(b, t, hp.FEATURE_SIZE, hp.EMBED_SIZE)

    def stream_state_init(self, batch: int, dtype=torch.float32,
                          device=None):
        """Each block's K/V cache of the last ATTN_LOOKBACK - 1 frames
        (zeros, marked invalid), the stream's frame count ``offset`` and the
        cache's fill count ``filled`` (int64 tensors on ``device``)."""
        w = self._causal_window()
        if not w:
            raise ValueError(
                "attn-v1 streams only with ATTN_CAUSAL=true (full "
                "bidirectional attention needs future context)")
        d, heads, n_layers, _ = self._dims()
        z = torch.zeros((batch, w - 1, heads, d // heads), dtype=dtype,
                        device=device)
        count = torch.zeros((), dtype=torch.int64, device=device)
        return {"cache": {f"block{i}": {"k": z, "v": z}
                          for i in range(n_layers)},
                "offset": count, "filled": count}

    def stream_hidden(self, params, x, state):
        """Centred chunk [B, Tc, F] -> (hidden [B, Tc, D], new state): each
        block's queries see its cached K/V and the chunk's own, under the
        band of ``apply`` and the cache's validity; logits in float32,
        masked entries at -1e9."""
        w = self._causal_window()
        d, heads, n_layers, _ = self._dims()
        hd = d // heads
        b, c = x.shape[0], x.shape[1]
        dev = x.device
        h = nn.linear_apply(params["embed"], x)
        h = h + self._posenc(c, d, h.dtype, dev, state["offset"])
        # the w - 1 cache slots are valid once `filled` frames have passed,
        # from the right; then the chunk's own frames
        filled = torch.clamp(state["filled"], max=w - 1)
        jidx = torch.arange(w - 1 + c, device=dev)
        key_valid = jidx >= (w - 1) - filled
        qpos = torch.arange(c, device=dev)[:, None] + (w - 1)
        mask = nn.causal_band(qpos, jidx[None, :], w) & key_valid[None, :]
        neg = torch.full((), -1e9, dtype=torch.float32, device=dev)
        new_cache = {}
        for i in range(n_layers):
            p = params[f"block{i}"]
            cache = state["cache"][f"block{i}"]
            y = nn.layer_norm(p["ln1"], h)
            qkv = nn.linear_apply(p["qkv"], y).reshape(b, c, 3, heads, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            kc = torch.cat([cache["k"].to(k.dtype), k], dim=1)
            vc = torch.cat([cache["v"].to(v.dtype), v], dim=1)
            logits = nn.ee("bqhd,bkhd->bhqk", q, kc) / torch.sqrt(
                torch.full((), hd, dtype=q.dtype, device=dev))
            logits = torch.where(mask[None, None], logits.float(), neg)
            attn = torch.softmax(logits, dim=-1).to(q.dtype)
            o = nn.ee("bhqk,bkhd->bqhd", attn, vc).reshape(b, c, d)
            h = h + nn.linear_apply(p["proj"], o)
            h = h + self._mlp(p, nn.layer_norm(p["ln2"], h))
            new_cache[f"block{i}"] = {"k": kc[:, kc.shape[1] - (w - 1):],
                                      "v": vc[:, vc.shape[1] - (w - 1):]}
        return h, {"cache": new_cache, "offset": state["offset"] + c,
                   "filled": torch.clamp(state["filled"] + c, max=w - 1)}

    def stream_head(self, params, h, mu):
        """The output head; the attention encoders centre no output, so
        ``mu`` is unused, as in the JAX package."""
        hp = self.hp
        out = nn.linear_apply(params["output"], h)
        return out.reshape(h.shape[0], h.shape[1], hp.FEATURE_SIZE,
                           hp.EMBED_SIZE)


@hparams.register_encoder("moe-v1")
class MoEAttentionEncoder(AttentionEncoder):
    """attn-v1 with a mixture-of-experts MLP in every block
    (``parallel/expert.py``): MOE_EXPERTS experts (default 4) of attn-v1's
    MLP width under ``block<i>["moe"]``.  MOE_TOP_K 0 mixes every expert
    (``moe_mlp``); MOE_TOP_K >= 1 routes each token to its top k, with
    MOE_CAPACITY_FACTOR's capacity in training (``moe_mlp_topk``) and
    without it otherwise (``moe_mlp_topk_dropless``).  Under MESH_EXPERT
    > 1, with a mesh that has the 'expert' axis, the mixture runs expert-
    parallel (``moe_mlp_ep``; routed training ``moe_mlp_ep_routed``), as
    ``danet_tpu/models/encoders.py:636-669`` routes it; routed training on
    a mesh without that axis counts the capacity over the global batch
    (``moe_mlp_topk``'s ``mesh``)."""

    def _n_experts(self):
        return _int_key(self.hp, "MOE_EXPERTS", 4)

    def _mlp_params(self, generator, d, mlp, device=None):
        n_exp = self._n_experts()
        scale_in = sqrt(6.0 / (d + mlp * d))
        return {"moe": {
            "router": nn.uniform_init(generator, (d, n_exp), 0.02, device),
            "w_in": nn.uniform_init(generator, (n_exp, d, mlp * d),
                                    scale_in, device),
            "w_out": nn.uniform_init(generator, (n_exp, mlp * d, d),
                                     scale_in, device),
        }}

    def _mlp(self, blk, y, train=False):
        hp = self.hp
        n_ep = int(getattr(hp, "MESH_EXPERT", 1) or 1)
        mesh = _route_mesh(hp, "expert", n_ep) if n_ep > 1 else None
        k = int(getattr(hp, "MOE_TOP_K", 0) or 0)
        if k <= 0:
            if mesh is not None:
                return expert.moe_mlp_ep(blk["moe"], y, mesh)
            return expert.moe_mlp(blk["moe"], y)
        if not train:
            # capacity drops depend on the other tokens of the batch:
            # inference is dropless, as in the JAX package
            return expert.moe_mlp_topk_dropless(blk["moe"], y, k=k)
        cf = float(getattr(hp, "MOE_CAPACITY_FACTOR", 1.25) or 1.25)
        if mesh is not None:
            return expert.moe_mlp_ep_routed(blk["moe"], y, mesh, k=k,
                                            capacity_factor=cf)
        return expert.moe_mlp_topk(blk["moe"], y, k=k, capacity_factor=cf,
                                   mesh=_rows_mesh())


@hparams.register_encoder("tcn-v1")
class TcnEncoder(Encoder):
    """Temporal convolutional encoder (Conv-TasNet's TCN as a DaNet
    embedding encoder): the bottleneck linear F -> D, then TCN_BLOCKS x
    TCN_REPEATS residual blocks of dilation 2 ** (i % TCN_BLOCKS), each
    layer norm -> linear D -> H -> leaky ReLU -> depthwise conv over T ->
    layer norm -> leaky ReLU -> linear H -> D, plus the residual; then the
    LSTM head.  TCN_CAUSAL left-pads the convolutions, and then the
    encoder streams, each block carrying the tail of its convolution's
    input.  Widths: TCN_DIM, TCN_HIDDEN, TCN_KERNEL.  Under MESH_SEQ > 1
    with a 'seq' axis the bottleneck and the blocks run on this rank's
    T-chunk (``parallel/seq_parallel.tcn_stack_sp``), gathered over 'seq'
    before the head."""

    SEQ_LEAVES = r"(bottleneck|block\d+)/"

    def _dims(self):
        hp = self.hp
        return (_int_key(hp, "TCN_DIM", 256), _int_key(hp, "TCN_HIDDEN", 512),
                _int_key(hp, "TCN_KERNEL", 3), _int_key(hp, "TCN_BLOCKS", 4),
                _int_key(hp, "TCN_REPEATS", 3),
                bool(getattr(hp, "TCN_CAUSAL", False)))

    def _n_blocks(self) -> int:
        _, _, _, x_blocks, repeats, _ = self._dims()
        return x_blocks * repeats

    def _dilation(self, i: int) -> int:
        return 2 ** (i % self._dims()[3])

    def init(self, generator, device=None):
        hp = self.hp
        d, h, k, _, _, _ = self._dims()
        params = {
            "bottleneck": nn.linear_init(generator, hp.FEATURE_SIZE, d,
                                         device=device),
            "output": _LstmHead.init(generator, hp, d, device),
        }
        for i in range(self._n_blocks()):
            params[f"block{i}"] = {
                "ln1": {"g": torch.ones(d, device=device),
                        "b": torch.zeros(d, device=device)},
                "in": nn.linear_init(generator, d, h, device=device),
                "dconv": nn.conv1d_depthwise_init(generator, h, k,
                                                  device=device),
                "ln2": {"g": torch.ones(h, device=device),
                        "b": torch.zeros(h, device=device)},
                "out": nn.linear_init(generator, h, d, device=device),
            }
        return params

    @staticmethod
    def _block(blk, h_seq, dilation: int, causal: bool, alpha: float):
        """One residual block over [B, T, D] (tasnet-v1 runs it too)."""
        y = nn.conv1d_depthwise_apply(
            blk["dconv"], nn.tcn_block_in(blk, h_seq, alpha),
            dilation=dilation, causal=causal)
        return nn.tcn_block_out(blk, h_seq, y, alpha)

    @staticmethod
    def _block_stream(blk, h_seq, dilation: int, alpha: float, tail):
        """One causal block over a chunk [B, Tc, D] after the tail [B,
        (K - 1) dilation, H] of its convolution's input: the convolution
        runs VALID over [tail | chunk] in float32, which is the offline
        causal convolution at these frames.  -> (out, the new tail)."""
        ycat = torch.cat([tail, nn.tcn_block_in(blk, h_seq, alpha)],
                         dim=1)
        y = nn.conv1d_depthwise_apply(blk["dconv"], ycat, dilation=dilation,
                                      valid=True)
        return (nn.tcn_block_out(blk, h_seq, y, alpha),
                ycat[:, ycat.shape[1] - tail.shape[1]:])

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB after every block, drawn from ``generator`` in
        block order; taps ``block<i>_h`` (none under MESH_SEQ, as in JAX:
        ``_apply_sp``)."""
        hp = self.hp
        causal = self._dims()[5]
        alpha = hp.RELU_LEAKAGE
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        x = _centered(log_spectra)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        mesh = _route_mesh(hp, "seq", n_seq) if n_seq > 1 else None
        if mesh is not None:
            return self._apply_sp(params, x, mesh, n_seq, keep, generator)
        h = nn.linear_apply(params["bottleneck"], x)
        # the recompute runs in the backward, after this loop: each
        # block's dilation is bound now
        layer = _maybe_remat(hp, lambda p, v, dilation: self._block(
            p, v, dilation, causal, alpha))
        for i in range(self._n_blocks()):
            h = layer(params[f"block{i}"], h, self._dilation(i))
            if generator is not None:
                h = nn.dropout(generator, h, keep)
            if tap:
                tap("block%d_h" % i, h)
        return _LstmHead.apply(params["output"], hp, h)

    def _apply_sp(self, params, x, mesh, n_seq, keep, generator):
        """The bottleneck and the blocks on this rank's T-chunk of the
        centred input (``seq_parallel.tcn_stack_sp``), gathered over 'seq'
        before the head (JAX ``danet_tpu/models/encoders.py:848-868``)."""
        from danet_tpu_torch.parallel import collectives, seq_parallel
        hp = self.hp
        if x.shape[1] % n_seq:
            raise ValueError("MESH_SEQ=%d must divide the frame count T=%d"
                             % (n_seq, x.shape[1]))
        _, _, k, _, _, causal = self._dims()
        h = seq_parallel.tcn_stack_sp(
            params, x, mesh,
            [self._dilation(i) for i in range(self._n_blocks())], k, causal,
            hp.RELU_LEAKAGE, data_axis=None, dropout_rng=generator,
            keep_prob=keep, remat=bool(getattr(hp, "REMAT", False)))
        h = collectives.leave_gather(mesh, h, "seq", 1)
        return _LstmHead.apply(params["output"], hp, h)

    def stream_state_init(self, batch: int, dtype=torch.float32,
                          device=None):
        """Each block's tail, zeros: the causal left padding of a fresh
        stream."""
        _, h, k, _, _, causal = self._dims()
        if not causal:
            raise ValueError(
                "tcn-v1 streams only with TCN_CAUSAL=true (non-causal "
                "depthwise convs need future frames)")
        return [torch.zeros((batch, (k - 1) * self._dilation(i), h),
                            dtype=dtype, device=device)
                for i in range(self._n_blocks())]

    def stream_hidden(self, params, x, state):
        """Centred chunk [B, Tc, F] -> (hidden [B, Tc, D], new tails)."""
        alpha = self.hp.RELU_LEAKAGE
        h = nn.linear_apply(params["bottleneck"], x)
        new_state = []
        for i in range(self._n_blocks()):
            h, tail = self._block_stream(params[f"block{i}"], h,
                                         self._dilation(i), alpha, state[i])
            new_state.append(tail)
        return h, new_state

    def stream_head(self, params, h, mu):
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


@hparams.register_encoder("dprnn-v1")
class DprnnEncoder(Encoder):
    """Dual-path RNN encoder (Luo, Chen & Yoshioka, ICASSP 2020) over STFT
    frames: the bottleneck linear F -> D; the frames cut into S chunks of
    P = DPRNN_CHUNK frames at DPRNN_HOP (P // 2 by default); DPRNN_BLOCKS
    blocks, each an intra-chunk BiLSTM over P (batched over B S) and an
    inter-chunk (Bi)LSTM over S (batched over B P), each path followed by
    a linear back to D, a layer norm and the residual; the chunks merged
    by count-normalised overlap-add; the LSTM head.  DPRNN_INTER_CAUSAL
    makes the inter-chunk LSTM one-directional; with DPRNN_HOP ==
    DPRNN_CHUNK besides (segments that do not overlap) the encoder streams
    whole segments, carrying the inter path's (c, h) per position.
    Widths: DPRNN_DIM (D), DPRNN_HIDDEN (H per direction).  Under MESH_SEQ
    > 1 with a 'seq' axis (DPRNN_HOP == DPRNN_CHUNK) the bottleneck and
    the blocks run on this rank's whole segments
    (``parallel/seq_parallel.dprnn_stack_sp``), gathered over 'seq' before
    the head."""

    SEQ_LEAVES = r"(bottleneck|block\d+)/"

    def _dims(self):
        hp = self.hp
        p = _int_key(hp, "DPRNN_CHUNK", 64)
        hop = _int_key(hp, "DPRNN_HOP", max(p // 2, 1))
        if not 1 <= hop <= p:
            raise ValueError(
                "DPRNN_HOP must be in [1, DPRNN_CHUNK]; got hop=%d P=%d"
                % (hop, p))
        return (_int_key(hp, "DPRNN_DIM", 128),
                _int_key(hp, "DPRNN_HIDDEN", 128), p, hop,
                _int_key(hp, "DPRNN_BLOCKS", 4),
                bool(getattr(hp, "DPRNN_INTER_CAUSAL", False)))

    def init(self, generator, device=None):
        hp = self.hp
        d, h, _, _, n_blocks, inter_causal = self._dims()
        gate_bias = (0.0, 0.0, 1.0, 0.0)      # forget-gate bias 1

        def ln():
            return {"g": torch.ones(d, device=device),
                    "b": torch.zeros(d, device=device)}

        params = {
            "bottleneck": nn.linear_init(generator, hp.FEATURE_SIZE, d,
                                         device=device),
            "output": _LstmHead.init(generator, hp, d, device),
        }
        for i in range(n_blocks):
            intra = rnn.bilstm_init(generator, d, h, gate_bias=gate_bias,
                                    device=device)
            intra_proj = nn.linear_init(generator, 2 * h, d, device=device)
            if inter_causal:
                inter = rnn.lstm_init(generator, d, h, gate_bias=gate_bias,
                                      device=device)
            else:
                inter = rnn.bilstm_init(generator, d, h,
                                        gate_bias=gate_bias, device=device)
            params[f"block{i}"] = {
                "intra": intra, "intra_proj": intra_proj, "intra_ln": ln(),
                "inter": inter,
                "inter_proj": nn.linear_init(
                    generator, h if inter_causal else 2 * h, d,
                    device=device),
                "inter_ln": ln(),
            }
        return params

    @staticmethod
    def _segment(x, p: int, hop=None):
        """[B, T, D] -> (chunks [B, S, P, D], (hop, T)): x zero-padded at
        the end to (S - 1) hop + P frames, chunk s its frames s hop ..
        s hop + P - 1; hop P // 2 by default, at most P."""
        t = x.shape[1]
        hop = max(p // 2, 1) if hop is None else min(hop, p)
        n_chunks = max(-(-(t - p) // hop), 0) + 1
        total = (n_chunks - 1) * hop + p
        x = torch.nn.functional.pad(x, (0, 0, 0, total - t))
        return x.unfold(1, p, hop).permute(0, 1, 3, 2), (hop, t)

    @staticmethod
    def _merge(chunks, seg_info):
        """Count-normalised overlap-add of chunks [B, S, P, D] back to
        [B, T, D].  The chunks that do not overlap (s mod m alike, m =
        ceil(P / hop)) are laid end to end as one slab, and the m slabs
        are summed in the order of s mod m: a fixed order, no atomics.
        The count is held in the chunks' dtype, as in the JAX package."""
        hop, t = seg_info
        b, s, p, d = chunks.shape
        total = (s - 1) * hop + p
        m = -(-p // hop)
        acc = None
        for r in range(min(m, s)):
            part = chunks[:, r::m]                       # [B, n, P, D]
            n = part.shape[1]
            slab = torch.nn.functional.pad(part, (0, 0, 0, m * hop - p)) \
                .reshape(b, n * m * hop, d)
            # chunk r + j m starts at frame (r + j m) hop
            slab = torch.nn.functional.pad(
                slab, (0, 0, r * hop, max(total - r * hop - n * m * hop, 0))
            )[:, :total]
            acc = slab if acc is None else acc + slab
        f = torch.arange(total, device=chunks.device)
        first = torch.clamp(torch.div(f - p + hop, hop,
                                      rounding_mode="floor"), min=0)
        last = torch.clamp(torch.div(f, hop, rounding_mode="floor"),
                           max=s - 1)
        cnt = (last - first + 1).to(chunks.dtype)
        return (acc / cnt[None, :, None])[:, :t]

    @staticmethod
    def _block(blk, chunks, inter_causal: bool, backend: str, masks=None,
               keep: float = 1.0, inter_state=None):
        """One dual-path block over chunks [B, S, P, D]; ``masks`` the
        intra and inter paths' dropout masks, drawn before the block.  With
        ``inter_state`` (streaming), the causal inter path resumes from the
        carried (c, h) [B P, H], and the block returns (chunks, the new
        carry)."""
        b, s, p, d = chunks.shape
        y = rnn.bilstm_apply(blk["intra"], chunks.reshape(b * s, p, d),
                             "tanh", backend=backend)
        y = nn.linear_apply(blk["intra_proj"], y).reshape(b, s, p, d)
        y = nn.layer_norm(blk["intra_ln"], y)
        if masks is not None:
            y = nn.dropout(None, y, keep, masks[0])
        chunks = chunks + y
        y = chunks.transpose(1, 2).reshape(b * p, s, d)
        new_state = None
        if inter_state is not None:
            y, new_state = rnn.lstm_apply(
                blk["inter"], y, "tanh", c0=inter_state[0],
                h0=inter_state[1], backend=backend, return_state=True)
        elif inter_causal:
            y = rnn.lstm_apply(blk["inter"], y, "tanh", backend=backend)
        else:
            y = rnn.bilstm_apply(blk["inter"], y, "tanh", backend=backend)
        y = nn.linear_apply(blk["inter_proj"], y)
        y = nn.layer_norm(blk["inter_ln"], y.reshape(b, p, s, d)
                          .transpose(1, 2))
        if masks is not None:
            y = nn.dropout(None, y, keep, masks[1])
        if inter_state is not None:
            return chunks + y, new_state
        return chunks + y

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB on each path's output, the masks drawn from
        ``generator`` before each block, intra then inter; taps
        ``block<i>_chunks`` (none under MESH_SEQ, as in JAX).  With T <
        DPRNN_CHUNK, one chunk of T frames at the default hop."""
        hp = self.hp
        _, _, p, hop, n_blocks, inter_causal = self._dims()
        backend = _backend(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        drop = generator is not None and keep < 1.0
        x = _centered(log_spectra)
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        mesh = _route_mesh(hp, "seq", n_seq) if n_seq > 1 else None
        if mesh is not None:
            # JAX danet_tpu/models/encoders.py:1052-1073
            if hop != p:
                raise ValueError(
                    "MESH_SEQ>1 with dprnn-v1 requires DPRNN_HOP == "
                    "DPRNN_CHUNK (non-overlapping segments; exact SP); "
                    "got hop=%d P=%d" % (hop, p))
            from danet_tpu_torch.parallel import collectives, seq_parallel
            h = seq_parallel.dprnn_stack_sp(
                params, x, mesh, p, n_blocks, inter_causal, backend=backend,
                data_axis=None, dropout_rng=generator if drop else None,
                keep_prob=keep, remat=bool(getattr(hp, "REMAT", False)))
            h = collectives.leave_gather(mesh, h, "seq", 1)
            return _LstmHead.apply(params["output"], hp, h)
        h = nn.linear_apply(params["bottleneck"], x)
        p_eff = min(p, h.shape[1])
        chunks, seg_info = self._segment(h, p_eff,
                                         hop if p_eff == p else None)
        layer = _maybe_remat(hp, lambda blk, c, masks: self._block(
            blk, c, inter_causal, backend, masks, keep))
        for i in range(n_blocks):
            masks = tuple(nn.dropout_mask(generator, chunks.shape, keep,
                                          chunks.device)
                          for _ in range(2)) if drop else None
            chunks = layer(params[f"block{i}"], chunks, masks)
            if tap:
                tap("block%d_chunks" % i, chunks)
        return _LstmHead.apply(params["output"], hp,
                               self._merge(chunks, seg_info))

    def stream_granularity(self) -> int:
        """A stream advances in whole segments of DPRNN_CHUNK frames."""
        return self._dims()[2]

    def sp_granularity(self) -> int:
        """Sequence parallelism shards whole DPRNN_CHUNK segments."""
        return self._dims()[2]

    def stream_state_init(self, batch: int, dtype=torch.float32,
                          device=None):
        """Each block's inter-path (c, h) per position [B P, H]: zeros, the
        offline scan's initial state; c in float32."""
        _, h, p, hop, n_blocks, inter_causal = self._dims()
        if not inter_causal or hop != p:
            raise ValueError(
                "dprnn-v1 streams only with DPRNN_INTER_CAUSAL=true and "
                "DPRNN_HOP == DPRNN_CHUNK (non-overlapping causal "
                "segments; got hop=%d P=%d)" % (hop, p))
        z = torch.zeros((batch * p, h), dtype=dtype, device=device)
        return [(z.to(_carry_dtype(dtype)), z) for _ in range(n_blocks)]

    def stream_hidden(self, params, x, state):
        """Centred chunk [B, Tc, F], Tc a multiple of DPRNN_CHUNK ->
        (hidden [B, Tc, D], new carries): per block kernel B on the
        segments (intra path) and kernel 1 across them (inter path)."""
        d, _, p, _, n_blocks, _ = self._dims()
        b, tc = x.shape[0], x.shape[1]
        if tc % p:
            raise ValueError(
                "dprnn-v1 stream chunks must be multiples of "
                "DPRNN_CHUNK=%d (got %d frames)" % (p, tc))
        chunks = nn.linear_apply(params["bottleneck"], x).reshape(
            b, tc // p, p, d)
        new_state = []
        for i in range(n_blocks):
            chunks, carry = self._block(params[f"block{i}"], chunks, True,
                                        _backend(self.hp),
                                        inter_state=state[i])
            new_state.append(carry)
        return chunks.reshape(b, tc, d), new_state

    def stream_head(self, params, h, mu):
        return _LstmHead.apply_centered(params["output"], self.hp, h, mu)


@hparams.register_encoder("conv-bilstm-v1")
class ConvBiLstmEncoder(Encoder):
    """CNN + BiLSTM hybrid (the reference's modules.py:263-379): down
    conv8-conv16-pool, conv32-conv16-pool and centering; two BiLSTMs of
    FFT_SIZE units over 2 FFT_SIZE inputs, the residual and re-centering;
    up conv32-conv64, a pixel shuffle x2 in T and F, conv16-conv8; a
    bias-free linear to F E.  T must be a multiple of LENGTH_ALIGN (4),
    and FEATURE_SIZE // 4 == FFT_SIZE // 8.  Under MESH_SEQ > 1 with a
    'seq' axis the whole encoder runs on this rank's T-chunk
    (``parallel/seq_parallel.conv_bilstm_sp``), its embeddings gathered
    over 'seq'; every leaf is then the chunk's alone."""

    ALIGN = 4   # two 2x2 pools, then a x2 shuffle and the fold of 4
    SEQ_LEAVES = r""

    def sp_granularity(self) -> int:
        """Each sequence-parallel chunk lands on the double-pooled grid (T
        a multiple of 4 S)."""
        return 4

    def init(self, generator, device=None):
        hp = self.hp
        nfft = hp.FFT_SIZE
        gate_bias = (0.0, 1.0, -1.0, 1.0)   # reference modules.py:282-285
        w_scale = 2.0 / sqrt(nfft)
        up_scale = 3e-1                     # reference modules.py:336-338

        def conv(i, o, k, scale=None):
            return nn.conv2d_init(generator, i, o, k, scale, device)

        return {
            "down0a": conv(1, 8, 5), "down0b": conv(8, 16, 5),
            "down1a": conv(16, 32, 3), "down1b": conv(32, 16, 3),
            "lstm0": rnn.bilstm_init(generator, nfft * 2, nfft, w_scale,
                                     gate_bias, device),
            "lstm1": rnn.bilstm_init(generator, nfft * 2, nfft, w_scale,
                                     gate_bias, device),
            "up0a": conv(16, 32, 3, up_scale),
            "up0b": conv(32, 64, 3, up_scale),
            "up1a": conv(16, 16, 5), "up1b": conv(16, 8, 5),
            "output": nn.linear_init(generator, nfft,
                                     hp.FEATURE_SIZE * hp.EMBED_SIZE,
                                     bias=False, device=device),
        }

    def apply(self, params, log_spectra, train=False, generator=None,
              tap=None):
        """[B, T, F] -> [B, T, F, E]; with ``train``, inverted dropout at
        DROPOUT_KEEP_PROB after each BiLSTM, drawn from ``generator``;
        taps ``conv_act``, ``lstm_act`` and ``mid4`` (on the dense path:
        taps run it under MESH_SEQ too, as in JAX).  Raises ValueError
        when T is not a multiple of LENGTH_ALIGN (4), or, on the
        sequence-parallel route, of 4 MESH_SEQ."""
        hp = self.hp
        nfft = hp.FFT_SIZE
        alpha = hp.RELU_LEAKAGE
        act = _candidate_activation(hp)
        keep = hp.DROPOUT_KEEP_PROB if train else 1.0
        b, t = log_spectra.shape[0], log_spectra.shape[1]
        n_seq = int(getattr(hp, "MESH_SEQ", 1) or 1)
        mesh = _route_mesh(hp, "seq", n_seq) if n_seq > 1 else None
        if mesh is not None and tap is None:
            # JAX danet_tpu/models/encoders.py:1184-1204
            if t % (4 * n_seq):
                raise ValueError(
                    "MESH_SEQ=%d needs T %% (4*MESH_SEQ) == 0 for the "
                    "conv-bilstm pooled grid; got T=%d — pick "
                    "MAX_TRAIN_LEN / TIME_BUCKET accordingly" % (n_seq, t))
            from danet_tpu_torch.parallel import collectives, seq_parallel
            out = seq_parallel.conv_bilstm_sp(
                params, log_spectra, mesh, nfft, hp.FEATURE_SIZE,
                hp.EMBED_SIZE, alpha, act, data_axis=None,
                dropout_rng=generator, keep_prob=keep,
                remat=bool(getattr(hp, "REMAT", False)))
            return collectives.leave_gather(mesh, out, "seq", 1)
        if t % self.ALIGN:
            raise ValueError(
                "conv-bilstm-v1 takes T a multiple of LENGTH_ALIGN (%d); got "
                "T=%d" % (self.ALIGN, t))

        def conv(name, v):
            return nn.leaky_relu(nn.conv2d_apply(params[name], v), alpha)

        x = conv("down0b", conv("down0a", log_spectra[:, None]))
        x = nn.max_pool_2x2(x)                         # [B, 16, T/2, F/2]
        if tap:
            tap("conv_act", x)
        x = nn.max_pool_2x2(conv("down1b", conv("down1a", x)))
        x = x - torch.mean(x, dim=(1, 2, 3), keepdim=True)  # [B, 16, T/4, F/8]
        skip = x
        seq = x.transpose(1, 2).reshape(b, x.shape[2], nfft * 2)
        for name in ("lstm0", "lstm1"):
            seq = rnn.bilstm_apply(params[name], seq, act,
                                   dropout_rng=generator, keep_prob=keep,
                                   backend=_backend(hp))
        if tap:
            tap("lstm_act", seq)
        x = seq.reshape(b, -1, 16, nfft // 8).transpose(1, 2) + skip
        x = x - torch.mean(x, dim=(1, 2, 3), keepdim=True)
        if tap:
            tap("mid4", x)
        x = conv("up0b", conv("up0a", x))              # [B, 64, T/4, F/8]
        t4 = x.shape[2]
        x = x.reshape(b, 16, 2, 2, t4, nfft // 8).permute(0, 1, 4, 2, 5, 3) \
            .reshape(b, 16, t4 * 2, nfft // 4)         # pixel shuffle x2
        x = conv("up1b", conv("up1a", x))              # [B, 8, T/2, F/4]
        x = x.transpose(1, 2).reshape(b, -1, nfft)
        out = nn.linear_apply(params["output"], x)
        return out.reshape(b, -1, hp.FEATURE_SIZE, hp.EMBED_SIZE)
