"""The benchmark's plain reference: the step of the simulated network in
plain PyTorch, frozen from the program's plain tensor path (its ``sim/``
and ``ops/`` modules) at the commit that added the benchmark, with its
imports pointed into this folder.

It imports nothing of the program and holds none of its kernels: every
seam runs its plainest formulation (the non-fused hop and emit, one
indexed gather per edge exchange, rank selection), whatever the
configuration asks for, on a single device, without fault plans. It
builds its own initial state from the underlay and parameters it is
given. A later change to the program does not change this copy.
"""
