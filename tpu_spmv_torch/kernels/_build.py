"""Builds the port's CUDA kernels and binds them through ctypes.

Every `.cu` file under `csrc/` (with the headers it includes from
there) is compiled by its own `nvcc`, all of them started together, and
the objects are linked into one shared library with a plain C
interface, for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o _build/<name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libtpu_spmv_torch_kernels.so _build/*.o

The library is built on first use, and again whenever a source is newer
than it, into `_build/` beside this file (listed in .gitignore). No
source includes PyTorch's headers, so a build takes seconds. Each C
entry launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on anything but 0. Pointers and
the stream cross as `c_void_p`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
LIB_PATH = BUILD_DIR / "libtpu_spmv_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
# C entry -> argument types (every entry returns the cudaError_t as int).
_SIGNATURES = {
    # val_kind, vals, offs, D, rb, x, y, m, n, stream
    "tsp_spmv_dia": (_I, _P, _P, _I, _I, _P, _P, _LL, _LL, _P),
    # val_kind, lcol_kind, vals, lcols, sub_b0, sub_dlo, sub_dhi,
    # grp_b0, G, gmap, seg_ptr, seg_chunk, num_segments, split_seg,
    # num_split, x, y, part, m, n, accumulate, stream
    "tsp_spmv_ranked": (
        _I, _I, _P, _P, _P, _P, _P, _P, _I, _U, _P, _P, _I, _P, _I, _P, _P,
        _P, _LL, _LL, _I, _P,
    ),
    # vals, cols, seg_ptr, seg_chunk, num_segments, split_seg,
    # num_split, x, y, part, m, n, stream
    "tsp_spmv_sell": (_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _LL, _LL, _P),
    # val_kind, lcol_kind, vals, lcols, sub_b0, sub_dlo, sub_dhi,
    # grp_b0, G, gmap, seg_ptr, seg_shift, seg_chunk, run_ptr, num_runs,
    # split_seg, num_split, X, Y, part, m, n, B, stream
    "tsp_packed": (
        _I, _I, _P, _P, _P, _P, _P, _P, _I, _U, _P, _I, _P, _P, _I, _P, _I,
        _P, _P, _P, _LL, _LL, _I, _P,
    ),
    # vals, cols, chunk_ptr, wait_ptr, wait_chunk, b_scale, x, flags,
    # num_chunks, x_blocks, stream
    "tsp_lower_solve_blocks": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _P),
    # lcol_kind, vals, lcols, sub_b0, sub_dlo, sub_dhi, chunk_ptr,
    # wait_ptr, wait_chunk, b_scale, x, flags, num_chunks, x_blocks,
    # stream
    "tsp_lower_solve_ranked": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _P,
    ),
    # val_kind, vals, offs, D, rb, S, W, stage_bytes, x, y, m, n, smem,
    # stream
    "tsp_spmv_dia_windowed": (
        _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _LL, _LL, _I, _P,
    ),
    # val_kind, D, rb, S, W, stage_bytes, m, smem -> CTAs (or minus the
    # CUDA error)
    "tsp_dia_windowed_ctas": (_I, _I, _I, _I, _I, _I, _LL, _I),
    # -> static shared memory bytes of the DIA ring's kernel (or minus
    # the CUDA error)
    "tsp_dia_windowed_static_smem": (),
    # val_kind, lcol_kind, vals, lcols, sub_b0, sub_dlo, sub_dhi,
    # num_subtiles, seg_ptr, seg_chunk, split_seg, num_split, step_seg,
    # step_lo, step_hi, num_steps, ring, stage_subtiles, X, Y, part, m, n,
    # B, stream
    "tsp_ranked_windowed": (
        _I, _I, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _I, _P, _P, _P, _I, _I,
        _I, _P, _P, _P, _LL, _LL, _I, _P,
    ),
    # val_kind, lcol_kind, num_steps, ring, stage_subtiles, B -> CTAs
    # (or minus the CUDA error)
    "tsp_ranked_windowed_ctas": (_I, _I, _I, _I, _I, _I),
}

_lib = None


@dataclasses.dataclass
class BuildInfo:
    path: pathlib.Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's stderr (the -Xptxas -v report when verbose)


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels cannot be built on this machine"
        )
    return found


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC_DIR.iterdir())


def build(verbose: bool = False, force: bool = False) -> BuildInfo:
    """Compile csrc/*.cu into LIB_PATH unless it is up to date: one nvcc
    per source, run in parallel, then one link.

    verbose passes -Xptxas -v, whose per-kernel register, shared-memory
    and spill report comes back in BuildInfo.log. Raises RuntimeError
    with nvcc's output when a compile or the link fails.
    """
    if not force and not _stale():
        return BuildInfo(LIB_PATH, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        out, err = proc.communicate()
        log.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = BUILD_DIR / f"{LIB_PATH.name}.{tag}.tmp"
        cmd = [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed with code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, LIB_PATH)  # atomic: a reader never sees half a file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildInfo(LIB_PATH, time.perf_counter() - t0, "".join(log))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.tsp_error_string.argtypes = [ctypes.c_int]
        lib.tsp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = library().tsp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(layout, x: torch.Tensor, what: str,
                   matrix: bool = False) -> None:
    """What every kernel wrapper requires before it hands out pointers:
    a contiguous float32 x of shape (n,) (or, with matrix=True, X of
    shape (n, B) with B >= 1, row-major) on a CUDA device, and every
    layout tensor contiguous on that same device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}, not a CUDA device")
    shape_ok = (
        x.dim() == 2 and x.shape[0] == layout.n and x.shape[1] >= 1
        if matrix else x.dim() == 1 and x.numel() == layout.n
    )
    if x.dtype != torch.float32 or not shape_ok:
        want = f"({layout.n}, B)" if matrix else f"({layout.n},)"
        raise ValueError(
            f"{what}: x must be float32 of shape {want}, got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    for name, t in layout.tensors().items():
        if t.device != x.device:
            raise ValueError(
                f"{what}: layout.{name} is on {t.device}, x on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: layout.{name} must be contiguous")
