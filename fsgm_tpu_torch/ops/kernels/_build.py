"""Build and load the hand-written Hopper kernels (fsgm_tpu_torch/csrc).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/fsgm_tpu_torch/lib<name>_<hash>.so <name>.cu

No ``--use_fast_math``: the extraction kernel's f32 division must stay IEEE
to reproduce the host's rint(subpixel) bit for bit.  ``-Xptxas -v`` reports
each kernel's registers, shared memory and spills; the report is kept
beside the library (``ptxas_log``).  The library name carries a hash of the
source, of the csrc headers it includes (``included_headers``) and of the
flags, so an edit to any of them rebuilds it and an unchanged one loads
from the build directory.  The build happens at
first use, never at import: importing this module needs no CUDA toolkit.

A library may hold several entry points (``ENTRY`` maps each kernel name
to its library, symbol and C signature; ``QUERIES`` are the entries that
launch nothing, such as K2's occupancy, and ``KERNELS`` the others).
Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.  ``LAUNCHES`` counts the
kernel launches made by the wrappers in ``ops/kernels/*.py``: each wrapper
adds one where it launches its kernel, and nowhere else, through
``utils/tracing.py::launched``, which also counts it in the open stage
span.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "fsgm_tpu_torch"
NVCC_FALLBACK = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# each entry point: kernel name -> (library csrc/<library>.cu, symbol,
# argtypes)
ENTRY = {
    "census_cost": ("cost", "fsgm_census_cost",
                    [_P, _P, _P] + [_I] * 7 + [_P]),
    "sgm_sweep": ("sgm_sweep", "fsgm_sgm_sweep", [_P] * 5 + [_I] * 12 + [_P]),
    "sgm_sweep_family": ("sgm_sweep", "fsgm_sgm_sweep_family",
                         [_P] * 3 + [_I] * 10 + [_P, _I, _P]),
    "sgm_sweep_occupancy": ("sgm_sweep", "fsgm_sgm_sweep_occupancy",
                            [_I] * 5 + [_P]),
    "extract_stereo": ("extract", "fsgm_extract_stereo",
                       [_P, _I] + [_P] * 5 + [_I] * 10 + [_P]),
    "wta_right": ("extract", "fsgm_wta_right", [_P, _I, _P] + [_I] * 5 + [_P]),
    "extract_flow": ("extract_flow", "fsgm_extract_flow",
                     [_P, _I] + [_P] * 7 + [_I] * 6 + [_P]),
    "label_minor_from_major": ("transpose", "fsgm_label_minor_from_major",
                               [_P, _P, _I, _I, _I, _P]),
    "min16_probe": ("min16_probe", "fsgm_min16_probe",
                    [_P, _P, _P, ctypes.c_longlong, _I, _P]),
}
LIBRARIES = sorted({lib for lib, _, _ in ENTRY.values()})
# entry points that launch nothing: they answer a question about a kernel
QUERIES = ("sgm_sweep_occupancy",)
KERNELS = tuple(name for name in ENTRY if name not in QUERIES)

LAUNCHES: collections.Counter = collections.Counter()


def find_nvcc() -> str:
    """Path of nvcc: the one on PATH, else the CUDA toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_FALLBACK.exists():
        return str(NVCC_FALLBACK)
    raise RuntimeError(
        "nvcc not found (not on PATH and no "
        f"{NVCC_FALLBACK}): the fsgm_tpu_torch CUDA kernels are compiled "
        "at first use and need the CUDA toolkit; CPU tensors take the "
        "plain PyTorch versions instead")


def included_headers(src: Path) -> list[Path]:
    """The csrc headers that src includes by a quoted name, and theirs."""
    found: list[Path] = []
    todo = [src]
    while todo:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               todo.pop().read_text(), flags=re.M):
            header = src.parent / name
            if header.exists() and header not in found:
                found.append(header)
                todo.append(header)
    return sorted(found)


def source_digest(src: Path) -> str:
    """Hash of src, the csrc headers it includes and the nvcc flags: the
    library's name, so that an edit to any of them rebuilds it."""
    h = hashlib.sha256(src.read_bytes())
    for header in included_headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library(name: str) -> Path:
    """Compile csrc/<name>.cu (if not built yet) and return the .so path."""
    src = SRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}_{source_digest(src)}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        lib.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of library csrc/<name>.cu, built if need
    be."""
    return build_library(name).with_suffix(".ptxas.txt").read_text()


def build_all() -> list[Path]:
    """Build every library at once: one nvcc process per source, all
    started together."""
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return list(pool.map(build_library, LIBRARIES))


@functools.cache
def load(name: str):
    """The C entry point of kernel ``name`` (ENTRY), its library built on
    first use."""
    lib, symbol, argtypes = ENTRY[name]
    fn = getattr(ctypes.CDLL(str(build_library(lib))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def stream_of(t) -> int:
    """The current CUDA stream handle of tensor t's device: the handle that
    torch.cuda.current_stream(t.device).cuda_stream gives, read without
    building a Stream object (a few microseconds of host time a launch)
    through a private torch call; chip_smoke.py's phase 9 holds it to the
    public handle on a side stream."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(t):
    """The context a launch for tensor t runs in: t's device made current,
    or nothing where it is current already (entering torch.cuda.device
    costs several microseconds of host time a launch)."""
    import torch
    if t.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
