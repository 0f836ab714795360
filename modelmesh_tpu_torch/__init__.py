"""PyTorch/CUDA port of modelmesh_tpu's accelerator paths.

The JAX package (``modelmesh_tpu``) is the reference; this package imports
neither it nor ``jax``. It holds the global placement solve (both tiers,
the steady-state refresh and the strategy; its kernels for Hopper under
``csrc/``), JAX's threefry PRNG (``random.py``, with the Gumbel draw on
the card in ``csrc/threefry.cu``), and the model runtime: the model
families (``models/families.py``, weights byte for byte the reference's)
and the in-process and gRPC model server (``models/server.py``).

Entry points run on the first CUDA device unless the caller passes
``device="cpu"`` (see ``device.py``).
"""
