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
# "gemm_nn"/"gemm_tn" the backward modes; "flash_fwd" counts the exact
# flash forward K5 (f32 or non-causal inputs), "flash_fwd_bound" the
# bound-max forward K8 (bf16 causal inputs, whichever arm its device
# predicate takes), "flash_dq"/"flash_dkv" the backward K6/K7;
# "flash_dkv_t" the transposed per-head dK/dV K11 and "flash_bwd_fused" the
# fused backward K10 (one count per call: its delta pre-pass, sweep and dQ
# epilogue are three launches); "paged_decode" K16 over f32/bf16 pools, "paged_decode_int8" K16 over
# int8 pools with per-position scales; "conv_fwd" counts K3a launches (forward and input
# gradient), "conv_dw" K3b, "pool" K4; "relu" ... "div" count K2, one
# per elementwise op; "adam" (Adam and AdamW) and "sgd" count K17a/K17b,
# one per launch over a table of tensors; "linear_q8" K12, "linear_q4" K13,
# "quantize_rows" K14, "matmul_int8_scaled" K15a and "matmul_int8" K15b.
EW_OPS = ("relu", "sigmoid", "add", "mul", "fma", "sub", "div")
QUANT_OPS = ("linear_q8", "linear_q4", "quantize_rows",
             "matmul_int8_scaled", "matmul_int8")
KERNELS = ("linear", "gemm_nn", "gemm_tn", "flash_fwd", "flash_fwd_bound",
           "flash_dq", "flash_dkv", "flash_dkv_t", "flash_bwd_fused",
           "paged_decode", "paged_decode_int8",
           "conv_fwd", "conv_dw", "pool") + EW_OPS + ("adam", "sgd") + QUANT_OPS
_launches = dict.fromkeys(KERNELS, 0)
# K1 calls by route (ops.gemm.plan): "wgmma nt", "f32 tn split", ...; the
# flash calls by route (ops.attention.plan_fwd / plan_bwd): "wgmma
# flash_fwd_bound", "wmma flash_dkv", ...; a tally of its own, so that the
# per-kernel counts stay one a call
_routes = {}
# K8 launches that took the bound arm, counted by the kernel itself on the
# device (the arm is decided there), one int32 counter per device
_bound_arm = {}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def count_route(route: str, mode: str, splits: int) -> None:
    key = f"{route} {mode}" + (" split" if splits > 1 else "")
    _routes[key] = _routes.get(key, 0) + 1


def route_counts() -> dict:
    """K1 calls by route and mode, and K8 and K7 calls by route, since the
    last :func:`reset_launch_counts` (" split" marks a split-K call)."""
    return dict(_routes)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
    _routes.clear()
    for counter in _bound_arm.values():
        counter.zero_()


def bound_arm_counter(device) -> torch.Tensor:
    """The device counter that K8 launches on ``device`` add to when they
    take the bound arm."""
    device = torch.device(device)
    if device not in _bound_arm:
        _bound_arm[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _bound_arm[device]


def bound_arm_count() -> int:
    """K8 launches that took the bound arm since the last
    :func:`reset_launch_counts`: one read from each device (a host sync)."""
    return sum(int(c.item()) for c in _bound_arm.values())


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
            f"{name}: the CUDA kernel has no backward (the JAX package has "
            f"none either); run it under torch.no_grad() or on tensors "
            f"that do not require grad")


def check_kernel_args(name: str, *tensors, dtypes=None,
                      aligned: bool = True) -> None:
    """Raise on inputs a kernel does not take: non-contiguous tensors,
    rows not 16-byte aligned (unless ``aligned`` is False: the kernel
    reads any address), or a dtype outside ``dtypes``."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors, got "
                             f"strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel needs 16-byte aligned tensors")
        if dtypes is not None and t.dtype not in dtypes:
            raise ValueError(f"{name}: kernel takes dtype in "
                             f"{tuple(dtypes)}, got {t.dtype}")
