"""Lagrangian particles: only the grid locator and the trilinear gather of
particles/core.py are ported (the superlayer tool samples along the
interface normals with them); the particles themselves are ROADMAP A15."""
