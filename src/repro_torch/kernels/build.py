"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
Nothing is built at import: the first wrapper call (or ``build_all``) builds
what is missing.  A library's file name carries a hash of its sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.

The libraries go to ``build/kernels/`` at the repository root (listed in
``.gitignore``), or to ``$REPRO_TORCH_BUILD_DIR`` when it is set.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
KERNELS = ("packed_prefill", "decode_attention", "flash_prefill", "paged_decode",
           "chunked_prefill", "fused_prefill", "kv_quant", "kv_dequant", "ssd_scan",
           "flash_backward", "ssd_backward")
# the other sources a kernel's .cu includes (every .cuh counts for all)
INCLUDES = {"ssd_backward": ("ssd_scan.cu",)}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "packed_prefill": (
        "packed_flash_attention_launch",
        # q k v q_pos kv_pos q_seg kv_seg out part_acc part_ml
        [_P] * 10
        # B Sq Skv H KV hd dtype causal has_window window
        + [_I] * 10 + [_F, _P],  # scale stream
    ),
    "decode_attention": (
        "decode_attention_launch",
        # q k v q_pos kv_pos kv_valid out part_acc part_ml
        [_P] * 9
        # B L H KV hd dtype has_window window parts
        + [_I] * 9 + [_F, _P],  # scale stream
    ),
    "flash_prefill": (
        "flash_attention_launch",
        # q k v q_pos kv_pos kv_valid out part_acc part_ml lse
        [_P] * 10
        # B Sq Skv H KV hd dtype causal has_window window
        + [_I] * 10 + [_F, _P],  # scale stream
    ),
    "paged_decode": (
        "paged_decode_attention_launch",
        # q k_pool v_pool block_table q_pos out part_acc part_ml
        [_P] * 8
        # B nb n_blocks block H KV hd dtype has_window window parts
        + [_I] * 11 + [_F, _P],  # scale stream
    ),
    "chunked_prefill": (
        "chunked_prefill_attention_launch",
        # q k_pool v_pool block_table q_pos out part_acc part_ml
        [_P] * 8
        # B C nb n_blocks block H KV hd dtype has_window window
        + [_I] * 11 + [_F, _P],  # scale stream
    ),
    "fused_prefill": (
        "fused_flash_attention_launch",
        # q k v q_pos kv_pos out part_acc part_ml
        [_P] * 8
        # B Sq Skv H KV hd dtype has_window window
        + [_I] * 9 + [_F, _P],  # scale stream
    ),
    # x q scale | rows | hd dtype | stream
    "kv_quant": ("kv_quant_launch", [_P] * 3 + [_L] + [_I] * 2 + [_P]),
    # q scale out | rows | hd dtype | stream
    "kv_dequant": ("kv_dequant_launch", [_P] * 3 + [_L] + [_I] * 2 + [_P]),
    # x dt A B C h0 (or null) y hT scratch (bf16; or null) | scratch floats
    # | B L H P G S chunk n_chunks dtype | stream
    "ssd_scan": ("ssd_chunked_launch", [_P] * 9 + [_L] + [_I] * 9 + [_P]),
    "flash_backward": (
        "flash_attention_bwd_launch",
        # q k v out dout q_pos kv_pos kv_valid lse D dq dk dv dk_part dv_part
        [_P] * 15
        # B Sq Skv H KV hd dtype causal has_window window
        + [_I] * 10 + [_F, _P],  # scale stream
    ),
    # x dt A B C h0 dy dhT (or null) dx ddt dA dB dC dh0 scratch | scratch
    # floats | B L H P G S n_chunks dtype | stream
    "ssd_backward": ("ssd_chunked_bwd_launch", [_P] * 15 + [_L] + [_I] * 8 + [_P]),
}

# the other C function of an attention library: the number of parts S the
# launch splits the kv tiles into, from which the wrapper sizes the scratch
_QUERIES = {
    "packed_prefill": ("packed_flash_attention_splits", [_I] * 3),  # Skv hd dtype
    "flash_prefill": ("flash_attention_splits", [_I] * 3),  # Skv hd dtype
    "chunked_prefill": ("chunked_prefill_attention_splits", [_I] * 4),  # nb block hd dtype
    "fused_prefill": ("fused_flash_attention_splits", [_I] * 3),  # Skv hd dtype
}

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    deps = [CSRC / dep for dep in INCLUDES.get(name, ())]
    for src in sorted(CSRC.glob("*.cuh")) + deps + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the seconds each build took (0.0 for a library that
    was already built).  Raises with the compiler's output on failure; the
    compiler's resource report (``-Xptxas -v``) is kept in ``<lib>.log``."""
    names = list(KERNELS if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)  # atomic: a concurrent builder sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for entry in (_SIGNATURES[name], _QUERIES.get(name)):
            if entry is not None:
                fn = getattr(lib, entry[0])
                fn.argtypes = entry[1]
                fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def launcher(name: str):
    """The C entry point of kernel ``name``, with its argument types set."""
    return getattr(library(name), _SIGNATURES[name][0])


@functools.lru_cache(maxsize=1024)
def splits(name: str, *args: int) -> int:
    """S, the number of parts the launch of kernel ``name`` with these
    shapes splits its kv tiles into (``_QUERIES``; the launcher's choice)."""
    return int(getattr(library(name), _QUERIES[name][0])(*args))


def ptxas_report(name: str) -> List[Dict[str, object]]:
    """What ``-Xptxas -v`` reported for each kernel of library ``name`` when
    it was built: ``function`` (the mangled name), ``registers`` per thread,
    ``spill_stores`` and ``spill_loads`` in bytes.  Empty when the library
    was built by another process and left no log."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    entries: List[Dict[str, object]] = []
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append({"function": m.group(1)})
            continue
        if not entries:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entries[-1]["spill_stores"] = int(m.group(1))
            entries[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
    return entries


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code {status}")
