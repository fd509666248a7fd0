"""Build and bind the port's CUDA kernels (`src/repro_torch/csrc/`).

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so
         src/repro_torch/csrc/<name>.cu

The build happens at first use, from the checkout's sources only, into
`build/repro_torch_kernels/` at the repository root (git-ignored). The
file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded. `build_all()` starts one
nvcc per source at once and waits for all of them. Nothing here runs
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U = ctypes.c_uint
_F = ctypes.c_float
# each source's C entry points and their argument types (pointers and the
# stream as c_void_p, sizes as c_int / c_int64, uint32 words as c_uint,
# scales as c_float); each launch returns a cudaError_t (the *_smem_bytes
# entries a byte count, flash_bwd_dkv_chunks a count)
SIGNATURES = {
    "lif_step": {"lif_step_launch": [_P] * 9 + [_I, _I, _P]},
    "threefry": {"split_randint_launch": [_P] * 3 + [_I, _I]
                 + [_U] * 3 + [_P]},
    "route_lif": {"route_lif_launch": [_P] * 16 + [_I] * 5 + [_I64, _P]},
    "spike_matmul": {"spike_matmul_launch":
                     [_P, _P, _I, _P, _P] + [_I] * 6 + [_P]},
    "flash_attention": {"flash_attention_launch":
                        [_P] * 5 + [_I] * 11 + [_F] + [_I64] * 12 + [_P],
                        "flash_attention_smem_bytes": [_I] * 3},
    "flash_attention_bwd": {
        "flash_bwd_dkv_launch": [_P] * 8 + [_I] * 12 + [_F] + [_I64] * 12
        + [_P],
        "flash_bwd_dq_launch": [_P] * 7 + [_I] * 11 + [_F] + [_I64] * 15
        + [_P],
        "flash_bwd_dkv_chunks": [_I] * 7,
        "flash_bwd_smem_bytes": [_I] * 4},
}

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[tuple, object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc
    process per source, all started together. Returns each build's
    compiler output (register and shared-memory use from -Xptxas -v);
    raises if any build fails."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    logs, failed = {}, []
    for n, (proc, tmp, path) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, path)     # atomic: readers never see a partial
        else:
            failed.append(n)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, entry: Optional[str] = None):
    """The bound C entry point `entry` of source `name` (its only one
    when None), building the library first if it is missing. Bound once:
    setting a ctypes function's argument types costs more than a launch."""
    fn = _bound.get((name, entry))
    if fn is not None:
        return fn
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    entries = SIGNATURES[name]
    (only,) = entries if entry is None else (entry,)
    fn = getattr(_loaded[name], only)
    fn.argtypes = entries[only]
    fn.restype = ctypes.c_int
    _bound[(name, entry)] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
