"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` file to an object, all files at
once in parallel processes, and links the objects into one shared library
with a plain C interface, named by a hash of the flags and of every file
under ``csrc/`` (the sources and the headers they include), under
``_build/`` beside this file (listed in ``.gitignore``). The first call
that needs a kernel builds it; later calls in the process, and later
processes on the same checkout, reuse the file. The library is bound with
``ctypes``: every pointer and the stream are ``c_void_p``. A missing
``nvcc`` raises. ``ptxas`` reports each kernel's registers, shared memory
and spills (``-Xptxas -v``); the report is kept beside the library
(``ptxas_log``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> argtypes of each extern "C" launcher (all return cudaError_t as int)
SIGNATURES = {
    "arena_gram_row": (_I, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _P),
    "arena_gram": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _P),
    "arena_combine": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
    "flat_gram_row": (_I, _P, _LL, _LL, _P, _LL, _I, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _P),
    "flat_gram": (_I, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "flat_combine": (_I, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _P),
    "flash_attention": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        *(_LL,) * 12, _I, _I, _P, _P),
    "flash_attention_wgmma": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              *(_LL,) * 12, _I, _I, _P, _P),
    "flash_attention_bwd": (_I, *(_P,) * 10, *(_I,) * 6, *(_LL,) * 24, _I,
                            _I, _P),
    "flash_attention_bwd_wgmma": (_I, *(_P,) * 10, *(_I,) * 6, *(_LL,) * 24,
                                  _I, _I, _P),
}


def sources():
    """The translation units: one nvcc each."""
    return sorted(CSRC.glob("*.cu"))


def _inputs():
    """Every file under csrc/ (sources and the headers they include)."""
    return sorted(p for p in CSRC.rglob("*") if p.is_file())


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs():
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> list:
    """Run the commands in parallel; wait for every one, then raise on the
    first that failed. Returns their outputs."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile the sources unless the library for their hash exists. The
    objects and the library are written in a temporary directory and the
    library is renamed into place, so a concurrent build never leaves a
    half-written library behind."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                         for obj, src in zip(objs, sources())])
        log = Path(tmp) / "ptxas.txt"
        log.write_text("".join(f"== {src.name}\n{text}"
                               for src, text in zip(sources(), logs)))
        lib = str(Path(tmp) / "lib.so")
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(log, _log_path(out))
        os.replace(lib, out)
    return out


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_log() -> str:
    """ptxas's report of the build (-Xptxas -v): per kernel, registers,
    shared memory, stack and spills."""
    return _log_path(build()).read_text()


def kernel_resources(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "stack", "smem"}} parsed from a ptxas -v report (smem is the static
    shared memory in bytes; dynamic shared memory is not in the report)."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line):
            name = m.group(1)
            out.setdefault(name, {"smem": 0})
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) "
                                      r"bytes spill stores, (\d+) bytes "
                                      r"spill loads", line)):
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                out[name]["smem"] = int(sm.group(1))
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every
    launcher's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
