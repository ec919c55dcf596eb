"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes)
exports a plain C interface and is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library under ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``).
The library's file name carries a hash of its source, so an edited
source is rebuilt and a stale build is never loaded.  Nothing here runs
at import time: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flash_attention.cu's ten wgmma instantiations are most of the build:
# its optimizer runs on every core (--split-compile); the other sources
# keep one thread each (ssd_scan's kernel timed slower built split)
SOURCE_FLAGS = {"flash_attention": ["--split-compile=0"]}

# C signatures of the exported launchers, by source: pointers and the
# stream are c_void_p (a bare int would be cut to 32 bits), sizes c_int,
# element counts that may pass 2^31 c_longlong.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "flash_attention": {"flash_attention_fwd":
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _I, _I, _I, _I, _I, _P, _P]},
    "paged_attention": {"paged_attention_fwd":
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
                        "paged_tc_blocks_per_sm": [_I, _I],
                        "paged_map_encodes": []},
    "nat_compress": {"nc_pack_fwd": [_P, _P, _P, _L, _I, _P],
                     "nc_unpack_fwd": [_P, _P, _L, _I, _P]},
    "ssd_scan": {"ssd_scan_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _P],
                 "ssd_scan_tile": [_I, _I, _I, _I]},
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    # the shared headers count too: a source includes any of them
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, [])
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that has no current build, one ``nvcc``
    per source, all started together.  Returns each kernel's ``ptxas``
    report (registers, shared memory, spills) or '' when it was cached."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, []), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {n: "" for n in names}
    failed: List[str] = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib
