"""Where the time of K1 (``topk_select``) goes, phase by phase, on one GPU.

    python3 tools/topk_phase_trace.py

1. Times the port's ``topk_select`` by CUDA graph replay (as chip_smoke.py
   does) at the decode shape (13 rows of 4096, k = 320) and the
   compression shape (130 rows, k = 80), each beside the same launch with
   k = -1: no select then runs, so that time is what reading a row,
   clearing the histograms, the bisection replay and writing the values
   and mask cost without the select.
2. Builds a copy of ``csrc/topk_select.cu`` with a ``clock64()`` stamp of
   thread 0 at each phase boundary (the histograms cleared; each digit's
   atomics and its find; the reduce barrier after the replay; the
   threshold read; the stores issued) and prints, for the same inputs,
   the median over the blocks of the cycles each phase took. A digit the
   select skipped prints nothing. The copy is the kernel itself with the
   stamps added; the stamps cost a few cycles each.

Builds into the port's git-ignored build directory; needs a CUDA device
and nvcc.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

# (text in topk_select.cu, the stamp index put after it); the index is
# an expression where the stamp sits in the digit pass (P = 0, 1, 2)
STAMPS = [
    ("  const size_t base = static_cast<size_t>(blockIdx.x) * d;\n", "0"),
    ("  if (lane == 0) sh.warp_max[warp] = kmax;\n  __syncthreads();\n", "1"),
    ("      }\n    }\n  }\n  __syncthreads();\n", "2 + 2 * P"),
    ("  dig = __shfl_sync(kFull, dig, hit);\n", "3 + 2 * P"),
    ("  __syncthreads();\n  float vk = k < 0", None),
    ("sh.lo;  // cnt(sel_hi) >= k ?\n", "9"),
]
PHASES = ["row read, histograms cleared"] + [
    f"digit {p}: {w}" for p in range(3) for w in ("atomics", "find")] + [
    "replay and reduce, barrier", "threshold", "stores issued"]
HEADER = """
static __device__ long long g_stamp[256][16];
#define STAMP(i) \\
  if (threadIdx.x == 0 && blockIdx.x < 256) \\
    g_stamp[blockIdx.x][i] = clock64();
extern "C" int stamps_read(long long* h) {
  return cudaMemcpyFromSymbol(h, g_stamp, sizeof(g_stamp));
}
extern "C" int stamps_clear() {
  static long long zero[256][16];
  return cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
}
"""


def traced_source() -> str:
    src = (build.CSRC / "topk_select.cu").read_text()
    for anchor, index in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"text not found once in topk_select.cu: "
                             f"{anchor!r}")
        if index is None:  # the reduce barrier: the stamp goes after it
            src = src.replace(anchor, anchor.replace(
                "  float vk", "  STAMP(8)\n  float vk"))
        else:
            src = src.replace(anchor, f"{anchor}  STAMP({index})\n")
    # the end of the kernel: after the last store
    end = "        mask[base + e] = sel ? 1 : 0;\n      }\n    }\n  }\n}"
    if src.count(end) != 1:
        raise SystemExit("end of topk_select_kernel not found once")
    src = src.replace(end, end[:-1] + "  STAMP(10)\n}")
    src = src.replace("namespace {\n", HEADER + "namespace {\n", 1)
    return re.sub(r"topk_select_f32\(", "topk_select_traced_f32(", src)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/topk_phase_trace.py needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [("decode", 13, 320), ("compression", 130, 80)]
    rows = {name: torch.randn(n, 4096, generator=gen, device=dev)
            for name, n, _ in shapes}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    for name, n, k in shapes:
        x = rows[name]
        t_sel = time_ms(lambda: ops.topk_select(x, k))
        t_none = time_ms(lambda: ops.topk_select(x, -1))
        floor = time_ms(lambda: build.empty_launch(dev))
        print(f"{name} (n={n}, k={k}): {t_sel * 1e3:.2f} us; with k = -1 "
              f"(no select) {t_none * 1e3:.2f} us; empty kernel "
              f"{floor * 1e3:.2f} us")

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "topk_traced.cu"
    so = build.BUILD_DIR / "libtopk_traced.so"
    cu.write_text(traced_source())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_select_traced_f32.argtypes = [p, p, p, i, i, i, p]
    for name, n, k in shapes:
        x = rows[name]
        val, mask = torch.empty_like(x), torch.empty(
            x.shape, dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):  # the last launch's stamps are read
            lib.stamps_clear()
            rc = lib.topk_select_traced_f32(x.data_ptr(), val.data_ptr(),
                                            mask.data_ptr(), n, 4096, k,
                                            stream)
            if rc:
                raise SystemExit(f"traced kernel: CUDA error {rc}")
        torch.cuda.synchronize()
        if not torch.equal(mask, ops.topk_select(x, k)[1]):
            raise SystemExit("the traced kernel's mask differs")
        raw = (ctypes.c_longlong * (256 * 16))()
        lib.stamps_read(raw)
        st = np.array(raw, dtype=np.int64).reshape(256, 16)[:n]
        parts, prev = [], st[:, 0]
        for j, phase in enumerate(PHASES, start=1):
            col = st[:, j]
            hit = col > 0
            if not hit.any():
                continue
            parts.append(f"{phase} {int(np.median((col - prev)[hit]))}")
            prev = np.where(col > 0, col, prev)
        total = int(np.median(prev - st[:, 0]))
        print(f"{name} phases (cycles of thread 0, median of {n} blocks): "
              + "; ".join(parts) + f"; total {total}")


if __name__ == "__main__":
    main()
