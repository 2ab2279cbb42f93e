"""Batched ops of the PyTorch port: packed words, scoring, selection, the
heartbeat, propagation, and the CUDA kernels' wrappers (permgather,
hopkernel) with their plain PyTorch versions."""
