"""Copies of the JAX package's jax-free core modules (clock, parameters,
wire and router types)."""
