"""The plain float32 reference of the benchmark's configurations
(``model.py``). It imports neither JAX, nor the JAX package, nor anything
of the port."""
