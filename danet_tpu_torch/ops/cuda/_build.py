"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``danet_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked into
ONE shared library with a plain C interface (no PyTorch headers, so the
build takes seconds rather than minutes).  The library
goes to ``danet_tpu_torch/_build/`` (listed in .gitignore) under a name
that carries a hash of the sources and flags, so an edited source
triggers a rebuild.  Nothing is downloaded: only the sources in the
package and the CUDA toolkit are used.

Importing this module does nothing; ``library()`` builds and loads.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# --split-compile=0: each nvcc optimizes its kernels on every core, so the
# longest source (lstm_scan_lean.cu, 48 kernel instances) no longer sets
# the build's time alone (on an H100 host of 8 cores: 31.8 s against 60.5
# s for the whole build; the SASS of every kernel but the LSTM state
# entries' is the same either way)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--split-compile=0"]

# (name, restype, argtypes) of every C entry point in csrc/
_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = [
    ("danet_stft_ri", _I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    ("danet_bilstm_scan", _I, [_P] * 6 + [_I] * 6 + [_P]),
    ("danet_bilstm_scan_train", _I, [_P] * 8 + [_I] * 6 + [_P]),
    ("danet_bilstm_scan_bwd", _I, [_P] * 8 + [_I] * 6 + [_P]),
    ("danet_lstm_scan", _I, [_P] * 6 + [_I] * 6 + [_P]),
    ("danet_lstm_scan_state", _I, [_P] * 7 + [_I] * 6 + [_P]),
    ("danet_lstm_scan_train", _I, [_P] * 8 + [_I] * 6 + [_P]),
    ("danet_lstm_scan_bwd", _I, [_P] * 8 + [_I] * 6 + [_P]),
    ("danet_lstm_scan_train_state", _I, [_P] * 9 + [_I] * 6 + [_P]),
    ("danet_lstm_scan_bwd_seeded", _I, [_P] * 9 + [_I] * 6 + [_P]),
    ("danet_gru_scan", _I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    ("danet_gru_scan_train", _I,
     [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    ("danet_gru_scan_bwd", _I, [_P] * 9 + [_I] * 4 + [_P]),
    ("danet_flash_attn", _I,
     [_P] * 7 + [_I] * 6 + [_L] * 3 + [_F, _P]),
    ("danet_flash_attn_bwd_dkv", _I,
     [_P] * 10 + [_I] * 5 + [_L] * 3 + [_F, _P]),
    ("danet_flash_attn_bwd_dq", _I,
     [_P] * 9 + [_I] * 5 + [_L] * 3 + [_F, _P]),
    ("danet_lstm_scan_max_rows", _I, [_I, _I, _I, _IP]),
    ("danet_lstm_scan_bwd_max_rows", _I, [_I, _IP]),
    ("danet_lstm_scan_blocks_per_sm", _I, [_I] * 5 + [_IP]),
    ("danet_lstm_scan_bwd_blocks_per_sm", _I, [_I] * 4 + [_IP]),
    ("danet_error_string", ctypes.c_char_p, [_I]),
]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the "
            "port's CUDA kernels cannot be built on this machine")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, "libdanet_kernels_%s.so"
                        % h.hexdigest()[:16])


def build() -> str:
    """Compile the kernels unless a library of the same hash exists;
    returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = "%s.%s.o" % (tmp, os.path.basename(src))
        cmd = [nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        # wait for every compile before raising, so none is left running
        failed = []
        for cmd, proc in procs:
            err = proc.communicate()[1]
            if proc.returncode != 0:
                failed.append((cmd, proc.returncode, err))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                "(%d) %s\n%s" % (rc, " ".join(cmd), err)
                for cmd, rc, err in failed))
        cmd = [nvcc] + NVCC_FLAGS + ["-shared", "-o", tmp] + objs
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stderr))
        os.replace(tmp, out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero status."""
    if status != 0:
        msg = library().danet_error_string(status).decode()
        raise RuntimeError("%s failed: %s (status %d)" % (what, msg, status))
