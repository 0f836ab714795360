"""PyTorch/CUDA port of modelmesh_tpu's accelerator paths.

The JAX package (``modelmesh_tpu``) is the reference; this package imports
neither it nor ``jax``. It holds the global placement solve (both tiers,
the steady-state refresh and the strategy; its kernels for Hopper under
``csrc/``), JAX's threefry PRNG (``random.py``, with the Gumbel and
normal draws on the card in ``csrc/threefry.cu``), and the model runtime:
the model families (``models/families.py``, weights byte for byte the
reference's, drawn on the model's device)
and the in-process and gRPC model server (``models/server.py``).

Entry points run on the first CUDA device unless the caller passes
``device="cpu"`` (see ``device.py``).
"""

import os
import sys

# cuBLAS without a workspace, so that it takes no kernel that splits a
# product's K sum over blocks (those need one). With a workspace, it splits for some shapes and not for others, so
# a row's f32 sums depend on the batch or fused group the row rides in;
# the transformer's bf16 rounding of the attention softmax then turns a
# last-bit difference into one of up to 1.5e-4 of max|logits| between a
# batched or fused predict and a solo one (tools/batch_parity.py). With no
# workspace the blocks before the readout give each row bitwise its solo
# values, and the logits differ in their last bits only. PyTorch
# reads the variable once, at the process's first cuBLAS call, so it is
# set on import; a value the caller set is kept.
#
# A process that reached CUDA before importing the port may already have
# made its first cuBLAS call, and then the setting comes too late and
# nothing says so. The state at import is recorded here (without
# importing torch only to ask), and ``device.check_cublas_import_order``
# refuses a CUDA model store in such a process unless the variable was
# ":0:0" from the start.
CUDA_UP_AT_IMPORT = "torch" in sys.modules and bool(
    sys.modules["torch"].cuda.is_initialized()
)
CUBLAS_SET_AT_IMPORT = os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":0:0"
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":0:0")
