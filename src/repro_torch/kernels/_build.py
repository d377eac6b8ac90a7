"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``.  The library is built at
first use into ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``) and rebuilt when a source's hash changes.  A failed
build raises; nothing falls back to the plain PyTorch versions.

``use_bounds_check()``, called before the first launch of a process, or
``XLB_BOUNDS_CHECK=1`` in its environment, selects the bounds-checking
variant instead: the same sources built with
``-DXLB_BOUNDS_CHECK`` (``csrc/bounds.cuh``: every computed index of
global and shared memory checked on the device; an index out of range
traps the launch) into ``build/repro_torch_bounds/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("admit.cu", "complete.cu", "route.cu", "relay.cu",
           "decode_attention.cu", "flash_attention.cu", "ssd_scan.cu",
           "dense_x9.cu", "launch_floor.cu")
HEADERS = ("match.cuh", "float_io.cuh",   # included; part of the hash
           "hopper.cuh", "bounds.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
BOUNDS_DIR = BUILD_DIR.parent / "repro_torch_bounds"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BOUNDS_FLAGS = ("-DXLB_BOUNDS_CHECK",)

#: shared memory a launch gets without opting in (48 KB)
SMEM_DEFAULT = 48 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

#: activation type codes of the float kernels (csrc/float_io.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# C signatures (argtypes) of the exported functions; pointers and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
SIGNATURES = {
    "xlb_complete": [_P] * 7 + [_P] * 4 + [_P] * 7 + [_P] * 5
                    + [_I] * 5 + [_F, _F, _P],
    "xlb_admit": [_P] * 7 + [_I, _I]            # requests, R, F
                 + [_P] * 5 + [_I, _I]          # svc + rule tables, S, NR
                 + [_P] * 3 + [_I]              # cluster tables, CL
                 + [_P] * 4 + [_I]              # endpoint tables, E
                 + [_P, _P, _I]                 # rr cursor, maglev, T
                 + [_P, _P, _I]                 # affinity cache, A
                 + [_P, _I, _I]                 # slot mask (null: all
                                                # free), I, C
                 + [_P] * 5                     # incoming pool
                 + [_P] * 5                     # per-request outputs
                 + [_P] * 7                     # carried-state outputs
                 + [_P] * 6                     # committed pool
                 + [_I, _I, _P],                # commit flag, tile rows,
                                                # stream
    "xlb_admit_smem_bytes": [_I] * 10,          # E, CL, S, NR, A, I, C, F,
                                                # all-free flag, tile rows
    "xlb_admit_init": [],
    "xlb_route": [_P, _P, _I, _I]               # svc, features, R, F
                 + [_P] * 5 + [_I, _I]          # svc + rule tables, S, NR
                 + [_P, _P, _I]                 # cluster windows, CL
                 + [_P, _I]                     # ep_load, E
                 + [_P, _P, _P],                # cluster, endpoint, stream
    "xlb_relay": [_P, _I, _I, _P, _P, _P],      # idx, N, n_dest, outs, stream
    "xlb_decode_attention": [_P] * 7            # q, k, v, lengths, out,
                                                # partials (acc, m/l)
                            + [_I] * 6          # B, H, K, S, hd, dtype
                            + [_L] * 8          # q, k, v strides
                            + [_I, _I, _F, _P],  # split, n_split, scale
    "xlb_flash_attention": [_P] * 4             # q, k, v, out
                           + [_I] * 7           # B, S, H, K, hd, dtype,
                                                # causal
                           + [_L] * 12          # q, k, v, out strides
                           + [_F, _P],          # scale, stream
    "xlb_ssd_scratch_floats": [_I] * 6          # B, S, nh, hd, N, dtype
                              + [_L, _L],       # B, C head strides
    "xlb_ssd_scan": [_P] * 7                    # x, a, B, C, y, h_last,
                                                # scratch
                    + [_I] * 6                  # B, S, nh, hd, N, dtype
                    + [_L] * 12                 # x, a, B, C strides
                    + [_P],                     # stream
    "xlb_dense_x9": [_P] * 4                    # x, planes, y, workspace
                    + [_I] * 4                  # M, K, N, grid
                    + [_P],                     # stream
    "xlb_empty_launches": [_I, _P],
    "xlb_error_string": [_I],
}
RESTYPES = {"xlb_error_string": ctypes.c_char_p,
            "xlb_ssd_scratch_floats": ctypes.c_longlong}

_lib: ctypes.CDLL | None = None
_ready: set[int] = set()    # device indices the library was set up on
#: the bounds-checking variant is selected (``use_bounds_check``, or
#: ``XLB_BOUNDS_CHECK=1`` in the environment of the process)
bounds_check = os.environ.get("XLB_BOUNDS_CHECK") == "1"
_sms: dict[int, int] = {}   # device index -> streaming multiprocessors
#: seconds the last build took (0.0 when an existing library was loaded)
build_seconds = 0.0
#: nvcc's output of the last build (-Xptxas -v: registers, smem, spills)
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    nvcc = str(cand) if cand.exists() else shutil.which("nvcc")
    if not nvcc:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the CUDA "
                           "kernels cannot be built")
    return nvcc


def use_bounds_check() -> None:
    """Build and load the bounds-checking variant in this process (before
    its first launch: a loaded library cannot be swapped)."""
    global bounds_check
    if _lib is not None and not bounds_check:
        raise RuntimeError("the kernel library is already loaded; select "
                           "the bounds-checking variant before any launch")
    bounds_check = True


def _flags() -> tuple:
    return NVCC_FLAGS + (BOUNDS_FLAGS if bounds_check else ())


def _digest() -> str:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def _build(target: Path) -> None:
    global build_log
    nvcc = _nvcc()
    tmp = target.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / (Path(s).stem + ".o") for s in SOURCES]
        log = _run_all([[nvcc, *_flags(), "-c", str(CSRC / s), "-o", str(o)]
                        for s, o in zip(SOURCES, objs)])
        so = tmp / target.name
        log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(so), *map(str, objs)]])
        os.replace(so, target)                # atomic: never a half file
        build_log = log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library(device: torch.device | None = None) -> ctypes.CDLL:
    """The loaded kernel library, built on first use and set up once per
    ``device`` (the admission kernel's shared-memory opt-in)."""
    global _lib, build_seconds
    if _lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA kernels need a CUDA device; torch "
                               "finds none")
        target = (BOUNDS_DIR if bounds_check else BUILD_DIR) \
            / f"libxlb_kernels_{_digest()}.so"
        t0 = time.perf_counter()
        if not target.exists():
            target.parent.mkdir(parents=True, exist_ok=True)
            _build(target)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    if device is not None:
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        if index not in _ready:
            with torch.cuda.device(index):
                check(_lib.xlb_admit_init(), "admit (set-up)")
            _ready.add(index)
    return _lib


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    """The number of streaming multiprocessors of ``device``."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index) \
            .multi_processor_count
    return _sms[index]


def as_i32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor; ``t`` itself when it is one."""
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor; ``t`` itself when it is one."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=64)
def _layout(shapes: tuple, itemsize: int) -> tuple:
    """(offsets, strides, total) of contiguous tensors of ``shapes`` laid
    one after another, each starting on a 16-byte boundary."""
    unit = 16 // itemsize
    offs, strides, total = [], [], 0
    for shape in shapes:
        offs.append(total)
        strides.append(tuple(math.prod(shape[d + 1:])
                             for d in range(len(shape))))
        total += -(-math.prod(shape) // unit) * unit
    return offs, strides, total


def packed(shapes: list[tuple[int, ...]], dtype: torch.dtype,
           device: torch.device) -> list[torch.Tensor]:
    """Contiguous tensors of ``shapes``, views of ONE allocation of
    ``dtype``, each starting on a 16-byte boundary (so a kernel may store
    them in 16-byte units): a wrapper's outputs for the price of one
    ``torch.empty`` and one ``as_strided`` each."""
    offs, strides, total = _layout(tuple(shapes), dtype.itemsize)
    buf = torch.empty((total,), dtype=dtype, device=device)
    return [buf.as_strided(shape, st, off)
            for shape, st, off in zip(shapes, strides, offs)]


def check_device(device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")


def check_16_byte(reader: str, name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` has a 16-byte aligned base and, but for its last
    (contiguous) axis, strides of 16-byte multiples (an axis of size 1 is
    never stepped): what a kernel that reads it with TMA or in 16-byte
    loads needs."""
    e = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(d) * e % 16
                                for d in range(t.dim() - 1) if t.shape[d] > 1):
        raise ValueError(
            f"{reader} reads {name} in 16-byte units: it needs a 16-byte "
            f"aligned base and strides of 16-byte multiples; got strides "
            f"{t.stride()} (elements of {e} B), base {t.data_ptr() % 16} B "
            f"past 16-byte alignment")


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = library().xlb_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name!r} failed: {msg} ({err})")
