"""Plain PyTorch references.  They import nothing of the port (or of jax,
or of the JAX package) and take nothing the program made: only the
benchmark's own inputs, and the program's outputs to judge them."""
