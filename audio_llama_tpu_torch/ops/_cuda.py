"""Build and load the port's CUDA kernels.

The sources under `audio_llama_tpu_torch/csrc/` are compiled with `nvcc` for
`sm_90a` into one shared library with a plain C interface, loaded with
`ctypes`. Each `.cu` file compiles to an object in its own `nvcc` process,
all started together, then one link makes the library. The library is built
at first use into `csrc/build/` (listed in `.gitignore`), named by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads at once. Nothing here runs when the package is imported: a host
without `nvcc` or a card imports every module and uses the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("layer_norm.cu", "enc_attention.cu", "causal_attention.cu", "decode_attention.cu",
           "mel_power.cu", "int4_matmul.cu", "mlp_int4.cu", "decode_attention_q4.cu",
           "decode_megakernel.cu", "causal_attention_bwd.cu", "decode_attention_db.cu",
           "decode_attention_packed.cu")
HEADERS = ("common.cuh", "attention_fwd.cuh", "int4_common.cuh", "decode_rows.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_STRIDES = [_L] * 12
SIGNATURES = {
    "al_layer_norm": [_I, _P, _P, _P, _P, _I, _I, _F, _P],
    "al_enc_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I] + _STRIDES + [_P],
    "al_causal_attention": [_P] * 7 + [_I] * 5 + _STRIDES + [_I, _P],
    "al_decode_attention": [_I] + [_P] * 7 + [_I] * 6 + [_F, _P, _P],
    "al_mel_power": [_P, _I, _L, _I, _I, _I, _P, _P, _I, _I, _P, _I, _P, _P],
    "al_int4_matmul": [_P, _I, _I, _P, _I, _P, _I, _P, _L, _L, _P, _P, _I, _I, _I, _P],
    "al_mlp_int4": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "al_decode_attention_q4": [_I] + [_P] * 9 + [_I] * 7 + [_F, _P, _P],
    "al_decode_attention_q8": [_I] + [_P] * 11 + [_I] * 7 + [_F, _P, _P],
    "al_decode_megakernel": [_P] * 24 + [_I] * 8 + [_F, _F, _I, _I, _P],
    "al_megakernel_blocks_per_sm": [_I, _I],
    "al_causal_attention_dq": [_P] * 9 + [_I] * 6 + [_P],
    "al_causal_attention_dkv": [_P] * 10 + [_I] * 6 + [_P],
    "al_decode_db_stats": [_I, _I] + [_P] * 10 + [_I] * 8 + [_F] + [_P] * 4,
    "al_decode_db": [_I, _I] + [_P] * 10 + [_I] * 8 + [_F] + [_P] * 2,
    "al_decode_packed": [_I, _I] + [_P] * 10 + [_I] * 9 + [_F] + [_P] * 7,
}

_lock = threading.Lock()
_lib = None
_counters = {}  # device -> int32 zeros shared by the split-sum kernels
_barriers = {}  # device -> the megakernel's grid-barrier words


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. The compiler's output, register and shared-memory use included,
    goes to `build/<hash>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    key = _digest()
    lib_path = BUILD_DIR / f"libaudio_llama_kernels_{key}.so"
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    log_path = BUILD_DIR / f"{key}.log"
    tag = f"{os.getpid()}"
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}_{key}_{tag}.o"
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if not failed:
        tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs]
        link = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"== link (rc {link.returncode})\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib_path)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    log_path.write_text("\n".join(logs))
    if failed:
        raise RuntimeError(
            f"CUDA kernel build failed ({', '.join(failed)}); see {log_path}:\n"
            + "\n".join(logs)[-4000:]
        )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def counters(device: torch.device, n: int) -> torch.Tensor:
    """n int32 zeros on `device` for the kernels that add their blocks'
    partial sums in a fixed order (ops/int4_matmul.py, ops/mlp_int4.py): the
    last block of a sum finds itself by an atomic count and resets the count
    to zero, so one buffer serves every launch on the stream."""
    with _lock:
        buf = _counters.get(device)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
            _counters[device] = buf
    return buf


def barrier_words(device: torch.device) -> torch.Tensor:
    """Two int32 words on `device` for the megakernel's grid barrier: an
    arrival count, zero between launches, and a generation that only
    grows. Launches on one stream run in turn, so one pair serves them all."""
    with _lock:
        buf = _barriers.get(device)
        if buf is None:
            buf = torch.zeros(2, dtype=torch.int32, device=device)
            _barriers[device] = buf
    return buf


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    return DTYPE_CODE[t.dtype]


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")


def require_shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0
