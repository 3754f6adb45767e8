"""fermi-tpu-torch: the FMD-index query path in PyTorch, with CUDA kernels
for Hopper (H100).

The package mirrors fermi_tpu's layout (core/, rld/, construct/, index/,
ops/, search/, cli/, api.py) so every module has an obvious counterpart.
It imports torch and never jax or fermi_tpu; the host code it needs
(FASTA parsing, the RLD codec, the text layout) is its own copy.

Every entry point runs on CUDA unless the caller names another device;
with no device named and no CUDA present it raises instead of running on
the CPU.
"""

__version__ = "0.1.0"

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one named, else CUDA.

    Raises when no device is named and CUDA is not available: the port
    never carries on silently on the CPU.  Pass device="cpu" to run the
    plain PyTorch versions of the kernels (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fermi_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' (or --device cpu) to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
