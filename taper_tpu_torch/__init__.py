"""taper_tpu_torch: the PyTorch + CUDA port of ``taper_tpu``.

The JAX package ``taper_tpu`` is the reference; this package runs the same
models with PyTorch, and every TPU kernel on its path is a hand-written
CUDA kernel for the H100 (``taper_tpu_torch/csrc``), built on first use.
Ops dispatch by the device of their tensors: CPU tensors run the plain
PyTorch versions, CUDA tensors the kernels.

Ported so far: TinyGPT serving (``serve.ServingEngine`` over
``models.TinyGPT``, with a contiguous or paged KV cache in the model's
dtype or int8), training the reference MNIST models (``train.Trainer``
over ``models.mnist_cnn`` and friends, with ``nn``, ``losses``, ``optim``
and ``data``), training TinyGPT (``TinyGPT.loss``;
``examples/train_tinylm.py``; the fused vocab-chunked loss, dropout,
remat, MoE, Adafactor/Lion/Muon and ``utils.amp``), training ResNet-8 on
CIFAR-10 and the
reference's XOR and MNIST-MLP examples (``models.resnet8``,
``data.CIFAR10Dataset``, ``data.DataLoader``, ``Trainer.fit``;
``examples/``), PTQ-quantized serving (``quantization``), and
checkpoints (``utils.checkpoint``, ``utils.safetensors_io``, the
Trainer's ``save_checkpoint``/``restore``/``resume``), generation
(``TinyGPT.generate``, ``beam_search``, ``speculative_generate``) and
``offline_serve``, whose decode loops replay captured CUDA graphs
(``utils.graphs``).  Importing this package imports no JAX,
builds nothing and does not initialise CUDA.
"""

__version__ = "0.1.0"

# the serving entry points, exported as the JAX package exports them
# (``taper_tpu/__init__.py``), and loaded on first use
_SERVE = ("ServingEngine", "offline_serve")
__all__ = list(_SERVE)


def __getattr__(name):
    if name in _SERVE:
        from taper_tpu_torch import serve
        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
