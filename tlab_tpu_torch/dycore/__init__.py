"""Dynamical cores (the incompressible main path)."""
