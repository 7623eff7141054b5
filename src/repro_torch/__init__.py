"""repro_torch — the PyTorch/CUDA port of the ``repro`` SC system.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and public names (``sc``, ``kernels``, ``models``,
``serve``, ``obs``, ``configs``, and for training ``optim``, ``train``,
``data``, ``checkpoint``, ``ft``, ``launch``) and is held against it by
the ``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and
never ``jax`` or anything of ``repro``.

Every kernel the JAX package wrote in Pallas and that the ported path
runs has a hand-written CUDA C++ kernel for Hopper (``sm_90a``) under
``csrc/``, built with ``nvcc`` on first use and bound with ``ctypes``
(``kernels/cuda_lib.py``).  Each wrapper launches its kernel for CUDA
tensors and runs the kernel's plain PyTorch version only for CPU tensors.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises when no card is present.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises when ``device`` is None and CUDA is unavailable — the port
    never carries on on the CPU unless the caller asked for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU"
            )
        device = "cuda"
    return torch.device(device)
