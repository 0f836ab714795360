"""PyTorch/CUDA port of modelmesh_tpu's global placement solver.

The JAX package (``modelmesh_tpu``) is the reference; this package imports
neither it nor ``jax``. It holds the sparse global-placement solve — cost
assembly, top-K candidate gather, sparse Sinkhorn, sparse auction — with
the Sinkhorn hot loop in three CUDA kernels for Hopper
(``csrc/masked_sparse.cu``), plus the host-side snapshot/dispatch/finalize
layer of ``placement/jax_engine.py`` (``placement/torch_engine.py``).

Entry points run on the first CUDA device unless the caller passes
``device="cpu"`` (see ``device.py``).
"""
