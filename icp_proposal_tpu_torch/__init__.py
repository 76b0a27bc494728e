"""PyTorch + CUDA port of ``icp_proposal_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package follows its layout and
names so each module's counterpart is found by path.  It imports ``torch``
and never ``jax``: the host-side numpy helpers the slice needs (STL reader,
Morton sort, seeded subsets, model building, shortlist index build) are
carried as copies, because importing any ``icp_proposal_tpu`` module pulls
in ``jax`` through that package's ``__init__``.

Every Pallas kernel on the ported path has a hand-written CUDA kernel for
``sm_90a`` in ``csrc/`` (built on first use by ``_build.py``), wrapped beside
a plain PyTorch twin in ``ops/chol_cuda.py`` and ``ops/closest_point_cuda.py``.
A wrapper takes its plain twin only for tensors on the CPU.  The kernels
have no backward: MALA's gradient flows through the elementwise recompute
of each closest-point winner, and a wrapper given a tensor that requires
grad raises.
"""
import torch

# Float32 products stay float32.  TF32 keeps bf16's 10-bit mantissa, which
# the reference measured to break closest-point exactness at femur
# coordinate scale (icp_proposal_tpu/ops/closest_point_pallas.py:449-457);
# the batched M = I + QᵀPQ assembly must not drop to it either.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
