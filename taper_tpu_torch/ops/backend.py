"""Kernel dispatch by tensor device, launch counts and precision policy.

The JAX package selects a global backend (``taper_tpu/ops/backend.py``:
``'xla'`` or ``'pallas'``).  The port has no switch: every op looks at the
device of the tensors it is given.  CPU tensors run the op's plain PyTorch
version (the correctness reference, the role ``ops/xla.py`` plays in the
JAX package); CUDA tensors run the hand-written kernel, or the wrapper
raises.  There is no fallback from a kernel to the plain version.

Each kernel wrapper adds one to its launch count where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import torch

# Precision policy, stated rather than inherited: f32 matrix products on
# the card run in full f32, never TF32 (the plain versions the kernels are
# held against, and the f32 logits product, rely on it).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Launch counters, one per kernel wrapper: "linear" is K1 in mode nt,
# "gemm_nn"/"gemm_tn" the backward modes; "conv_fwd" counts K3a launches
# (forward and input gradient), "conv_dw" K3b, "pool" K4.
KERNELS = ("linear", "gemm_nn", "gemm_tn", "flash_fwd", "paged_decode",
           "conv_fwd", "conv_dw", "pool")
_launches = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def on_cuda(*tensors) -> bool:
    """True when every given tensor lies on a CUDA device (run the
    kernel), False when every one lies on the CPU (run the plain version).
    ``None`` entries are ignored; a mix of devices raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel without a backward kernel would be recorded
    for autograd: a detached result would make the loss's gradient
    silently wrong.  The plain versions on the CPU stay differentiable."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet (it comes with "
            f"M2, the TinyGPT training step); run it under torch.no_grad() "
            f"or on tensors that do not require grad")


def check_kernel_args(name: str, *tensors, dtypes=None) -> None:
    """Raise on inputs a kernel does not take: non-contiguous tensors,
    rows not 16-byte aligned, or a dtype outside ``dtypes``."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors, got "
                             f"strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel needs 16-byte aligned tensors")
        if dtypes is not None and t.dtype not in dtypes:
            raise ValueError(f"{name}: kernel takes dtype in "
                             f"{tuple(dtypes)}, got {t.dtype}")
