"""Card and toolchain report of the port.

Counterpart of `python -m tpu_spmv.tools.info`: prints the toolchain
(torch, CUDA, nvcc, triton) and, when a card is present, its
nvidia-smi name and power limit and the DeviceSpec the roofline uses,
so recorded numbers can be tied to hardware.

Usage: python -m tpu_spmv_torch.tools.info
"""

from __future__ import annotations

import dataclasses
import platform
import sys


def main(argv=None):
    del argv
    import torch

    from tpu_spmv_torch import hw

    print(f"python: {platform.python_version()}")
    print(f"host: {platform.platform()}")
    for k, v in hw.toolchain().items():
        print(f"{k}: {v}")
    if not torch.cuda.is_available():
        print("device: none (no CUDA card)")
        return 1
    print(f"device_count: {torch.cuda.device_count()}")
    print(f"nvidia-smi: {hw.nvidia_smi()}")
    for k, v in dataclasses.asdict(hw.device_spec()).items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
