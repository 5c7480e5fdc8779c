"""PyTorch + CUDA port of the Auxo reproduction (the JAX package ``repro``
stays the reference). Same module layout as ``repro``; every Pallas kernel
on a ported path is a CUDA C++ kernel for Hopper (``kernels/csrc``).

float32 matmuls stay full float32 (no TF32) so that results match the JAX
package's float32 arithmetic; TF32 keeps only ~10 mantissa bits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU. ``None`` means "cuda" and raises on a host without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions"
        )
    return dev
