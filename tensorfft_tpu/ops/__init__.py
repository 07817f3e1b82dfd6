"""Compute kernels: the plain-JAX stage engine and its dot algorithms."""
