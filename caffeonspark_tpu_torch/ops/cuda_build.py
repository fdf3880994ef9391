"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface and loaded with ctypes: no PyTorch
headers, so a build takes seconds to a minute.  All sources compile in
parallel (one `nvcc` each, started together, each splitting its
device-code optimization over the machine's cores).  Libraries land in
`build/torch_kernels/` at the repository root, named by the hash of
their source and flags, so a later process of the same checkout loads
an earlier one's build instead of compiling again.

Nothing here runs at import time: the CPU tests import every module,
and a build starts only when a wrapper in `ops.kernels` is handed a
CUDA tensor (or a caller such as chip_smoke.py asks for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SOURCES = ("lrn", "int8_matmul", "flash_attn")
# nvcc's device-code optimizer runs on this many threads a source
# (flash_attn.cu instantiates some 60 kernels; one thread takes minutes)
SPLIT = max(1, os.cpu_count() or 1)

# the process's loaded libraries: one load per process, shared by every
# wrapper (a loaded CUDA library is a process-wide resource)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """`nvcc` from $CUDA_HOME, /usr/local/cuda, or PATH; raises when
    the toolkit is missing (a machine without a card often has none)."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(ARCH_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(jobs: Dict[str, Path], verbose: bool = False
             ) -> Dict[str, str]:
    """Compile each {source path: library path} job with the port's nvcc
    flags, all at once (one nvcc process each); raises with every
    failure's output.  Returns {source path: compiler output}."""
    nvcc = find_nvcc()
    procs = {}
    for src, out in jobs.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", f"-split-compile={SPLIT}",
               "-o", str(tmp), str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    outputs: Dict[str, str] = {}
    errors = []
    for src, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        outputs[src] = text
        if proc.returncode != 0:
            errors.append(f"nvcc {Path(src).name} failed ({proc.returncode}):"
                          f"\n{text}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def build_all(verbose: bool = False) -> Dict[str, object]:
    """Compile every source that has no up-to-date library, all at once
    (one nvcc process per source).  Returns a report: `libraries`
    {name: path}, `built` (the names compiled now), `seconds`, and
    `nvcc` {name: compiler output}, which with `verbose` holds the
    `-Xptxas -v` report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in SOURCES}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    t0 = time.monotonic()
    nvcc_out: Dict[str, str] = {}
    if todo:
        outputs = _compile({CSRC / f"{n}.cu": p for n, p in todo.items()},
                           verbose)
        nvcc_out = {n: outputs[CSRC / f"{n}.cu"] for n in todo}
    return {"libraries": targets, "built": sorted(todo),
            "seconds": time.monotonic() - t0, "nvcc": nvcc_out}


def build_variants(name: str, sources: Dict[str, str],
                   out_dir: Path) -> Dict[str, ctypes.CDLL]:
    """Build and load edited copies of csrc/<name>.cu ({variant: source
    text}) with the port's flags into `out_dir`, each declared as
    <name>'s library: for timing a kernel's variants against each
    other.  The port itself never loads them."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {v: out_dir / f"lib{name}_{v}.so" for v in sources}
    jobs = {}
    for variant, text in sources.items():
        src = out_dir / f"{name}_{variant}.cu"
        src.write_text(text)
        jobs[src] = libs[variant]
    _compile(jobs)
    return {v: _declare(name, ctypes.CDLL(str(p))) for v, p in libs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()["libraries"]
            for n, p in paths.items():
                _libs[n] = _declare(n, ctypes.CDLL(str(p)))
            lib = _libs[name]
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes/restype for every entry point: pointers and the stream
    as c_void_p (a bare int would be cut to 32 bits)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "lrn":
        lib.cos_lrn_fwd.argtypes = [P, P, I, I, I, I, F, F, F, I, I, I, I,
                                    P]
        lib.cos_lrn_fwd.restype = I
        lib.cos_bias_relu_lrn_fwd.argtypes = [P, P, P, I, I, I, I, F, F, F,
                                              I, I, I, P]
        lib.cos_bias_relu_lrn_fwd.restype = I
        lib.cos_lrn_bwd.argtypes = [P, P, P, I, I, I, I, F, F, F, F, F, I,
                                    I, I, I, P]
        lib.cos_lrn_bwd.restype = I
        lib.cos_lrn_occupancy.argtypes = [I, I, I, I, I]
        lib.cos_lrn_occupancy.restype = I
        lib.cos_bias_relu_lrn_bwd.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                              F, F, F, F, F, I, I, I, P]
        lib.cos_bias_relu_lrn_bwd.restype = I
        lib.cos_bias_relu_lrn_bwd_occupancy.argtypes = [I, I, I]
        lib.cos_bias_relu_lrn_bwd_occupancy.restype = I
    elif name == "int8_matmul":
        lib.cos_int8_matmul.argtypes = [P, P, P, I, I, I, P]
        lib.cos_int8_matmul.restype = I
    elif name == "flash_attn":
        # each kernel's padded-width entry point and its `_wide` twin
        # take the same arguments
        for suffix in ("", "_wide"):
            fwd = getattr(lib, "cos_flash_fwd" + suffix)
            fwd.argtypes = [P, P, P, P, P, I, I, I, F, I, I, P]
            dq = getattr(lib, "cos_flash_bwd_dq" + suffix)
            dq.argtypes = [P, P, P, P, P, P, P, I, I, I, F, I, I, I, P]
            dkv = getattr(lib, "cos_flash_bwd_dkv" + suffix)
            dkv.argtypes = [P, P, P, P, P, P, P, P, I, I, I, F, I, I, I, P]
            hop = getattr(lib, "cos_flash_block_update" + suffix)
            hop.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, I,
                            I, I, P]
            for fn in (fwd, dq, dkv, hop):
                fn.restype = I
    return lib
