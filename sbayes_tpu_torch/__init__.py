"""sbayes_tpu_torch: the PyTorch and CUDA port of ``sbayes_tpu``.

A second package beside the JAX one, with the same module layout and
names. Chain-state tensors carry an explicit leading chain axis, entry
points take an explicit ``device`` (``"cuda"`` by default) and randomness
comes from explicit ``torch.Generator``s. The collapsed likelihood and the
membership marginal run as hand-written CUDA kernels (``csrc/``) on CUDA
tensors and as their plain PyTorch versions on CPU tensors.

float32 matrix products and convolutions are pinned to full float32 at
import: TF32 would truncate the exact integer-valued count products.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
