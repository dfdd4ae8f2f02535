"""PyTorch / CUDA port of commander_tpu (the amplitude + C_ell Gibbs step).

The JAX package ``commander_tpu`` is the reference; this package mirrors its
layout (sphere/, model/, instrument/, ops/, sampling/, utils/) and keeps its
function names and array layouts at every public function. The on-the-fly
Legendre stage runs in two hand-written CUDA kernels (csrc/) on CUDA tensors
and in a plain chunked torch recurrence on CPU tensors.

Matmul precision: the reference runs its Legendre contractions in full FP32
(SHTPlan.mat_prec = "float32"; a bf16 pass was rejected at 2e-3 error), so
TF32 is switched off here, once, for every torch matmul and convolution.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
