"""PyTorch/CUDA port of parallel_eda_tpu (FPGA place-and-route).

The JAX package ``parallel_eda_tpu`` is the reference; this package
mirrors its module names (``route/planes.py`` here is the counterpart
of ``parallel_eda_tpu/route/planes.py``) and never imports it or jax.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see device.py).  The planes relaxation runs as two
hand-written CUDA kernels (csrc/planes_relax.cu) on the card and as
their plain PyTorch versions on the CPU.
"""
