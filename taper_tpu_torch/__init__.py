"""taper_tpu_torch: the PyTorch + CUDA port of ``taper_tpu``.

The JAX package ``taper_tpu`` is the reference; this package runs the same
models with PyTorch, and every TPU kernel on its path is a hand-written
CUDA kernel for the H100 (``taper_tpu_torch/csrc``), built on first use.
Ops dispatch by the device of their tensors: CPU tensors run the plain
PyTorch versions, CUDA tensors the kernels.

Ported so far: paged TinyGPT serving (``serve.ServingEngine`` over
``models.TinyGPT``), and training the reference MNIST models
(``train.Trainer`` over ``models.mnist_cnn`` and friends, with ``nn``,
``losses``, ``optim`` and ``data``).  Importing this package imports no
JAX, builds nothing and does not initialise CUDA.
"""

__version__ = "0.1.0"
