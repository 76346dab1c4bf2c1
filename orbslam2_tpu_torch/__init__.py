"""orbslam2_tpu_torch — the PyTorch/CUDA port of ``orbslam2_tpu``.

Same layout as the JAX package (``ops/``, ``models/``, ``utils/``,
``runtime/``, ``parallel/``, ``tools/``); each module's docstring names
the JAX file it ports.  ``parallel/`` holds the mesh of shards (one
thread a shard, a ``torch.distributed`` group across processes), the
point-sharded global BA and the row-sharded keyframe DB; the engines
take it only where there is more than one CUDA device.  The
port imports torch and numpy only — never jax, never ``orbslam2_tpu`` —
so it starts on a GPU host that has no jax.  The numpy-only modules it
needs (``config.py``, ``ops/pattern.py``, ``utils/synthetic.py``) are
copies, because importing any module of the JAX package imports jax
(``orbslam2_tpu/__init__.py:19``).

Hand-written Hopper kernels live in ``csrc/`` and are built at first use
by ``kernels/build.py``; each wrapper falls back to its plain PyTorch
version only for tensors on the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry runs in true FP32, mirroring the forced "highest" matmul
# precision of orbslam2_tpu/__init__.py:28-29: reduced precision diverged
# the trajectory there.  cuDNN's TF32 defaults to on, so it is set too.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from orbslam2_tpu_torch.config import SlamConfig  # noqa: E402,F401
