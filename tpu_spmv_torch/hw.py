"""The card and the toolchain the port runs on.

Counterpart of `tpu_spmv/hw.py`. `device_spec()` describes the CUDA
card from `torch.cuda.get_device_properties` plus the data-sheet HBM
bandwidth, the roofline ceiling. It raises when no card is present: no
CPU spec is ever dressed up as a device. `toolchain()` reports what this
machine has for building and running the kernels (nvcc, torch, CUDA,
triton), so every recorded run says what it was built with.
`kernel_calibration()` reads the planner's cost constants measured on
the current card (tools.tune --calibrate) from a table keyed by card
name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess

import torch

# Data-sheet HBM bandwidth by card name (NVIDIA H100 SXM5 and H200 SXM
# data sheets). These are the rates at the full 700 W power limit; a
# card set lower (nvidia-smi's power.limit) streams slower under load.
_HBM_BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}

# The H100's L2 cache (50 MB, as torch.cuda.get_device_properties reports
# it): what the x-residency gates (kernels/dia.dia_x_fits,
# kernels/sell.resident_x_fits) charge against when no card is at hand,
# e.g. a `--device cpu` run of the CLIs.
H100_L2_BYTES = 50 * 2**20
# Shared memory one block of threads can opt into on an H100 (227 KB):
# what the windowed kernels' x windows are held to (kernels/dia.py,
# kernels/sell.py) when no card is at hand.
H100_SMEM_PER_BLOCK = 232_448


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str  # torch.cuda.get_device_name
    sm_count: int
    l2_bytes: int
    smem_per_block: int  # opt-in maximum of dynamic shared memory
    total_bytes: int  # device memory
    hbm_bytes_per_s: float  # data-sheet bandwidth (roofline ceiling)
    capability: tuple


def hbm_bytes_per_s(kind: str) -> float:
    for key, bw in _HBM_BYTES_PER_S.items():
        if key in kind:
            return bw
    raise ValueError(
        f"no data-sheet HBM bandwidth for {kind!r}; known: "
        + ", ".join(_HBM_BYTES_PER_S)
    )


def device_spec(device=None) -> DeviceSpec:
    """Spec of a CUDA card (default: the current one). Raises
    RuntimeError when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the device spec needs a card")
    dev = torch.device("cuda" if device is None else device)
    p = torch.cuda.get_device_properties(dev)
    return DeviceSpec(
        kind=p.name,
        sm_count=p.multi_processor_count,
        l2_bytes=p.L2_cache_size,
        smem_per_block=p.shared_memory_per_block_optin,
        total_bytes=p.total_memory,
        hbm_bytes_per_s=hbm_bytes_per_s(p.name),
        capability=(p.major, p.minor),
    )


def _on_card(device) -> bool:
    """Whether `device` (None: the current card) names a present card."""
    if device is not None and torch.device(device).type != "cuda":
        return False
    return torch.cuda.is_available()


def target_device(device=None) -> torch.device:
    """The device a layout is built for: `device`, or the card when None.
    Raises RuntimeError for a CUDA device when no card is present (pass
    device="cpu" for the plain versions)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on a CUDA card (pass "
            'device="cpu" for the plain PyTorch versions)'
        )
    return device


def l2_bytes(device=None) -> int:
    """L2 bytes of the CUDA card `device` (a CUDA device, or None for the
    current card when one is present); H100_L2_BYTES for a CPU device or
    when no card is present."""
    return device_spec(device).l2_bytes if _on_card(device) else H100_L2_BYTES


def smem_per_block(device=None) -> int:
    """Shared memory a block can opt into on `device`, as l2_bytes
    resolves it; H100_SMEM_PER_BLOCK without a card."""
    if not _on_card(device):
        return H100_SMEM_PER_BLOCK
    return device_spec(device).smem_per_block


# The variable that names the one calibration file to read (and that
# tools.tune --calibrate writes), ahead of the user cache and the shipped
# table.
CALIB_ENV = "TPU_SPMV_TORCH_CALIB"
USER_CALIB = os.path.join("~", ".cache", "tpu_spmv_torch", "calib.json")
SHIPPED_CALIB = os.path.join(os.path.dirname(__file__), "data", "calib.json")


def device_kind() -> str:
    """The key of the current card in a calibration table: its
    torch.cuda.get_device_name, or "cpu" without a card (no shipped entry
    has that key, so the planner then runs on its module defaults unless
    $TPU_SPMV_TORCH_CALIB gives a "cpu" entry)."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def calib_paths() -> list:
    """The calibration files kernel_calibration reads, in order:
    $TPU_SPMV_TORCH_CALIB alone when set; else the user cache, then the
    table shipped in tpu_spmv_torch/data/."""
    env = os.environ.get(CALIB_ENV)
    if env:
        return [env]
    return [os.path.expanduser(USER_CALIB), SHIPPED_CALIB]


def kernel_calibration() -> dict:
    """The planner's measured cost constants (tune/model.py) for the
    current device kind: the first non-empty entry under device_kind()
    in calib_paths() (tpu_spmv.hw.kernel_calibration). A file without an
    entry for this kind does not hide a later one, so a user cache
    written on another card leaves the shipped entry in force. {} means
    the module defaults apply."""
    kind = device_kind()
    for path in calib_paths():
        try:
            with open(path) as f:
                table = json.load(f)
        except (OSError, ValueError):
            continue
        entry = table.get(kind, {}) if isinstance(table, dict) else {}
        if isinstance(entry, dict) and entry:
            return entry
    return {}


def nvidia_smi() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def nvcc_version() -> str:
    """The release line of `nvcc --version`, or why there is none."""
    from tpu_spmv_torch.kernels._build import nvcc

    try:
        out = subprocess.run(
            [nvcc(), "--version"], capture_output=True, text=True, check=True
        ).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        return f"unavailable ({e})"
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip()


def toolchain() -> dict:
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc_version(),
        "triton": importlib.util.find_spec("triton") is not None,
        "cuda_available": torch.cuda.is_available(),
    }
