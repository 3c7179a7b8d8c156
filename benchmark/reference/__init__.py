"""The benchmark's plain reference of the REINA day step.

A frozen copy of the port's host compile (``core/params.py``,
``core/schedule.py``, ``core/state.py``, the configuration and the data
archives), its plain day step (``core/step.py``) and the plain PyTorch
twins of its kernels (``ops/``: threefry, the samplers, the fused bodies,
the ledger, the prefix sums and the histograms), with every kernel path
taken out: it runs the same semantics in plain PyTorch on any device.
It imports nothing of the program under test, of the JAX package or of
JAX. ``build`` compiles a run from variables, ``step`` runs one day of
it from a given state; ``lower`` runs the same day with every float32
that the step reads and writes rounded to bfloat16 (the control of the
comparison that decides ``correct``).
"""
