"""PyTorch + CUDA port of ``ikpso_tpu`` (particle-swarm inverse kinematics).

The JAX package ``ikpso_tpu`` is the reference; this package holds the
same main path (batched Euler-XYZ tree FK, the position cost, the fused
PSO megakernel, the SoA Levenberg-Marquardt polish and the top-k retry
rounds) in plain PyTorch plus hand-written CUDA kernels for Hopper
(``csrc/``). It imports neither ``jax`` nor ``ikpso_tpu``.

Device setup: float32 matrix products must run in full float32. TF32
keeps ~10 mantissa bits, which puts millimetre-scale error into the FK
compose — the GPU twin of the TPU MXU-precision trap the reference
guards with ``precision="highest"`` (``ikpso_tpu/ops/fk.py``). Both
flags are PyTorch's defaults for matmul but not for cuDNN; they are set
here explicitly so no caller's global setting can change the FK.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
