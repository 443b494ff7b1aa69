"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` compiles each source with a plain C interface for
``sm_90a`` (one process per source, all started together), links the
objects into one shared library, and ``ctypes`` loads it. Sources come
from this package only; the library lands in ``_build/`` beside them
(listed in ``.gitignore``) under a name that carries the hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. No ``--use_fast_math``: the sign epilogues compare
against 0 and the BIHT update is held to a few ulp.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on anything but 0. Each wrapper also counts its launches
here (``count``), so a run can show which kernels its path went through;
a CUDA graph's replays add the launches its capture recorded
(``add_launches``, ``engine/graph.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "topk_select_f32": [_P, _P, _P, _I, _I, _I, _P],
    "cs_project_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "backproject_f32": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cs_project_pack_resid_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "backproject_packed_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "prefix_eval_f32": [_P, _P, _P, _P, _I, _I, _P],
    "repro_empty_launch": [_P],
}

#: Kernel name -> launches since the last reset.
LAUNCHES: Dict[str, int] = {"topk_select": 0, "cs_project": 0,
                            "cs_project_resid": 0, "backproject": 0,
                            "cs_project_pack_resid": 0,
                            "backproject_packed": 0, "prefix_eval": 0}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put the counts back to ``counts``: a CUDA graph capture calls the
    wrappers, which records their kernels and launches none."""
    LAUNCHES.update(counts)


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """``times`` replays of a CUDA graph whose capture recorded
    ``counts``: each replay launches every recorded kernel again."""
    for name, n in counts.items():
        LAUNCHES[name] += n * times


class BuildInfo(NamedTuple):
    path: Path
    seconds: float      # 0.0 when a library of the same hash was loaded
    ptxas_log: str      # -Xptxas -v output of every source


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "repro_torch cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the sources if the library for their hash is missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = source_hash()
    so = BUILD_DIR / f"librepro_kernels_{tag}.so"
    log = BUILD_DIR / f"ptxas_{tag}.log"
    if so.exists():
        return BuildInfo(so, 0.0, log.read_text() if log.exists() else "")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    pid = os.getpid()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}_{tag}_{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    tmp = BUILD_DIR / f"librepro_kernels_{tag}.{pid}.tmp"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    for _, obj, _ in jobs:
        obj.unlink()
    log.write_text("\n".join(logs))
    os.replace(tmp, so)
    return BuildInfo(so, time.perf_counter() - t0, "\n".join(logs))


_LIB: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
        handle.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if rc:
        msg = lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def empty_launch(device: torch.device) -> None:
    """Launch the empty kernel on ``device``'s current stream: the launch
    floor that every kernel pays (timed by chip_smoke.py; counted
    nowhere)."""
    check(lib().repro_empty_launch(
        torch.cuda.current_stream(device).cuda_stream), "empty_launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape, dtype=torch.float32,
            device: Optional[torch.device] = None) -> None:
    """Validate what a CUDA kernel takes: device, dtype, shape, layout.
    One boolean test on the fast path: the decode calls this ~300 times a
    round, so the message is built only on failure."""
    if (t.is_cuda and (device is None or t.device == device)
            and t.dtype == dtype and t.shape == tuple(shape)
            and t.is_contiguous()):
        return
    raise ValueError(
        f"{name}: the CUDA kernel takes a contiguous {dtype} tensor of "
        f"shape {tuple(shape)} on {device or 'a CUDA device'}; got "
        f"{t.dtype} {tuple(t.shape)} on {t.device}"
        f"{'' if t.is_contiguous() else ', not contiguous'}")


def require_vec4(name: str, d: int, *tensors: torch.Tensor) -> None:
    """Bodies that read rows in 16-byte pieces (K2/K3/K5 at every n,
    K4/K6 at n <= 16) take D % 4 == 0 and 16-byte aligned rows; anything
    else raises here rather than reaching another body."""
    if d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return
    raise ValueError(
        f"{name}: the CUDA kernel takes D % 4 == 0 and 16-byte aligned "
        f"rows at this row count; got D = {d}, data at "
        f"{[t.data_ptr() % 16 for t in tensors]} mod 16")
