"""REINA on PyTorch and CUDA: a port of the ``reina_tpu`` engine.

The JAX package ``reina_tpu`` is the reference. This package runs its
main path — ``core.engine.build_run`` → ``run_days`` → ``day_step`` —
on tensors of an explicit device. On CUDA the Pallas kernels of that
path are hand-written Hopper kernels (``kernels/``); on the CPU their
plain PyTorch twins run. The package imports torch and never jax; of
the JAX package it uses only the jax-free ``reina_tpu.config`` and
``reina_tpu.data``.

Layout:

  core/       constants, params, schedule, state (numpy host compile,
              carried over from the JAX package), step, engine
  ops/        prng (jax.random's threefry, bit for bit), random
              (samplers), fusedmap, clamped, compact (kernel wrappers
              and their twins)
  kernels/    csrc/*.cu (nvcc, ctypes), fused_bodies.py (Triton)
  convert.py  numpy values → tensors on a device
  testing.py  synthetic runs
"""

__version__ = "0.1.0"
