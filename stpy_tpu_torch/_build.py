"""Build and load the port's hand-written CUDA kernels.

Every source under ``csrc/`` (the ``*.cuh`` headers there are included by
the sources) compiles with its own ``nvcc -c``, all started together, and
one more ``nvcc -shared`` links the objects into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), which is
loaded with ``ctypes``. The library goes into
``<build root>/<hash of the sources and flags>/``, so an edited source
builds anew and an unchanged one is reused; the build root is
``build/stpy_tpu_torch/`` at the repository root (see :func:`build_root`).
The compiler's messages, ptxas's register and shared-memory report among
them, are kept beside the library in ``nvcc.log``.

Nothing is built or loaded when the package is imported: the first kernel
launch calls :func:`library`. Every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
nonzero code — a launch the driver refuses never runs, and a later
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"


def build_root(package_dir: Path = CSRC.parent) -> Path:
    """``build/stpy_tpu_torch/`` in the source checkout that holds the
    package (its ``.gitignore`` lists ``build/``); for an installed copy,
    which has no checkout around it, ``stpy_tpu_torch/`` in the per-user
    cache (``$XDG_CACHE_HOME`` or ``~/.cache``)."""
    checkout = package_dir.parent
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "stpy_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "stpy_tpu_torch"


BUILD_ROOT = build_root()
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
LIB_NAME = "libstpy_tpu_torch.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, y, out, n, m, d, kappa, shape, stream
    "stpy_gram_f32": (_P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P),
    # x, y, hi, lo, n, m, d, kappa, shape, stream
    "stpy_gram_df": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _I, _P),
    # x, y, hi, lo, n, m, d, kappa, shape, stage, stream
    "stpy_gram_df_stage": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _I, _I,
                           _P),
    # sqh, sql, hi, lo, n, shape, stage, stream
    "stpy_gram_df_stages": (_P, _P, _P, _P, _I, _I, _I, _P),
    # ah, al, v, vl, oh, ol, m, k, stream
    "stpy_gemv_df": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # x, y, out, n, m, d, kappa, inv_g2, stream
    "stpy_gram_l1": (_P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P),
    # th, tl, w0k, w0a, bh, bl, s2, part, scratch, c, n, t, stream
    "stpy_qform_df": (_P, _P, _P, _P, _P, _P, ctypes.c_double, _P, _P, _I, _I,
                      _I, _P),
    # c, n, t -> doubles of stpy_qform_df's scratch
    "stpy_qform_df_scratch": (_I, _I, _I),
    # part, row tiles, t, qh, ql, stream
    "stpy_qform_df_reduce": (_P, _I, _I, _P, _P, _P),
    # c -> rows of the partial-sum buffer of stpy_qform_df
    "stpy_qform_df_row_tiles": (_I,),
    # x, y, v, out, scratch, n, m, d, kappa, shape, stream
    "stpy_gram_matvec": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                         _P),
    # n, m, d -> floats of stpy_gram_matvec's scratch
    "stpy_gram_matvec_scratch": (_I, _I, _I),
    # x, y, V, out, vth, vtl, yt, n, m, d, r, kappa, shape, stream
    "stpy_gram_matmat": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         ctypes.c_float, _I, _P),
    # C, W, m, k, ldc, ldw, stream
    "stpy_syrk_lower": (_P, _P, _I, _I, _I, _I, _P),
    # A, n, lda, stream
    "stpy_chol_leaf": (_P, _I, _I, _P),
    # n -> blocks of the leaf's cooperative launch
    "stpy_chol_leaf_grid": (_I,),
}
# the entry points that return a count of scratch elements, not an error code
_COUNTS = ("stpy_gram_matvec_scratch", "stpy_qform_df_scratch")

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def compile_command(src: Path, obj: Path) -> list[str]:
    """The nvcc invocation that compiles one source into `obj`."""
    return [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objects, output: Path) -> list[str]:
    """The nvcc invocation that links the objects into the library."""
    return [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(output),
            *map(str, objects)]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def build() -> Path:
    """Compile the library unless this exact set of sources already was."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # per-process temporary names + atomic rename: concurrent builders
    # never load a half-written library
    tag = os.getpid()
    srcs = sources()
    objs = [lib.with_name(f".{src.stem}.{tag}.o") for src in srcs]
    tmp = lib.with_name(f".{LIB_NAME}.{tag}.tmp")
    cmds = [compile_command(s, o) for s, o in zip(srcs, objs)]
    log = []
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        codes = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            codes.append(proc.returncode)
            log.append(f"$ {' '.join(cmd)}\n{out}")
        if not any(codes):
            proc = subprocess.run(link_command(objs, tmp), capture_output=True,
                                  text=True)
            codes.append(proc.returncode)
            log.append(f"$ {' '.join(link_command(objs, tmp))}\n"
                       f"{proc.stdout}{proc.stderr}")
        if any(codes):
            raise RuntimeError("nvcc failed:\n" + "\n".join(log))
        (lib.parent / "nvcc.log").write_text("\n".join(log))
        os.replace(tmp, lib)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = (ctypes.c_longlong if name in _COUNTS
                              else ctypes.c_int)
            lib.stpy_cuda_error_string.argtypes = [ctypes.c_int]
            lib.stpy_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().stpy_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
