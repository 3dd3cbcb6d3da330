"""Numerical operators: stencils, boundary conditions, momentum, pressure."""
