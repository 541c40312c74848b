"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by hand with ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together, then one
link) into a shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch headers are included, so a build takes seconds.
The library lives in ``build/repro_torch_kernels/<digest>/`` at the
repository root, where the digest covers the sources and the flags: it is
built at first use and again whenever a source changes.
``--use_fast_math`` is deliberately absent (see the note in ``sturm.cu``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sturm.cu", "sturm_segmented.cu", "prod_diff.cu", "minor_det.cu",
           "runtime.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argument types (every one returns a CUDA error
#: code, 0 on success).
SIGNATURES = {
    "sturm_bisect_f32": (_P, _P, _P, _P) + (_I,) * 7 + (_P,),
    "sturm_bisect_f64": (_P, _P, _P, _P) + (_I,) * 7 + (_P,),
    "sturm_segmented_f32": (_P,) * 9 + (_I,) * 7 + (_P,),
    "sturm_segmented_f64": (_P,) * 9 + (_I,) * 7 + (_P,),
    "logabs_sum_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "logabs_sum_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "logabs_sum_masked_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "logabs_sum_masked_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "minor_det_f32": (_P,) * 5 + (_I,) * 5 + (_P,),
    "minor_det_f64": (_P,) * 5 + (_I,) * 5 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_dir() -> Path:
    """Directory of the library built from the current sources."""
    return BUILD_ROOT / _digest()


def _compile(out_dir: Path) -> None:
    """Compile every source (in parallel) and link the library in ``out_dir``;
    ``nvcc``'s own report (``-Xptxas -v``) goes to ``ptxas.txt``."""
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        report.append(f"== {src}\n{text}")
        if proc.returncode:
            failed.append(src)
    (out_dir / "ptxas.txt").write_text("\n".join(report))
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(report))
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(out_dir / LIB_NAME), *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")


def build() -> Path:
    """Build the library for the current sources unless it exists; returns
    its directory.  The build happens in a temporary directory that is
    renamed into place, so a half-built library is never loaded."""
    target = library_dir()
    if (target / LIB_NAME).is_file():
        return target
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        _compile(tmp)
        try:
            tmp.rename(target)
        except OSError:  # another process finished the same build first
            if not (target / LIB_NAME).is_file():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build() / LIB_NAME))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code:
        text = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {code} ({text})")


def launch(name: str, device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` (a tensor passes its
    data pointer, an int itself) and ``device``'s current stream; raise if
    the launch was refused.  The kernel runs asynchronously."""
    import torch

    lib = library()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(*ptrs, stream)
    check(lib, name, code)
