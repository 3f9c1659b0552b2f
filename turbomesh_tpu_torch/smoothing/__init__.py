"""Elliptic (Winslow/Poisson) multi-block smoothing.

Reference parity: src/core/smoothing/ (smooth.zig, wall_control_function.zig,
solver.zig + Krylov backends).

Interchangeable solver paths produce the same smoothed mesh:

- ``system`` — host-side sparse assembly of the exact reference
  discretization; solved direct (scipy LU — the correctness oracle) or
  with the host GMRES/BiCGStab Krylov backends + diagonal/ilu0
  preconditioning (the reference's gmres/bicgstab options).
- ``device`` — matrix-free stencil operators on the padded block stack in
  torch, f64 FGMRES per solve preconditioned by an f32 glued multigrid
  V-cycle (zebra line relaxation: ops.zebra, a CUDA kernel on the card).
"""

from .smooth import smooth_mesh, SmoothOptions

__all__ = ["smooth_mesh", "SmoothOptions"]
