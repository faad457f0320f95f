"""Numerical building blocks: rotations, the batched IPM QP solvers."""
