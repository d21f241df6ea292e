"""Operators: derivatives, the fused Burgers kernel, the factorized Poisson."""
