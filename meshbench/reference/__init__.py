"""The plain reference the benchmark judges the port's meshes against.

A frozen NumPy/SciPy copy of the port's front end (O4H blocking, TFI,
boundary classification), of the White control function and of the
assembly of the linearized Winslow system, taken from
``turbomesh_tpu_torch`` and then left alone: it imports nothing of the
port, of JAX or of the JAX package, so a later change to the port cannot
move the yardstick. ``judge`` holds the comparisons that decide a run's
``correct``.
"""
