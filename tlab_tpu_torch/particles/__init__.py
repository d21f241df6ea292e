"""Lagrangian particles (port of tlab_tpu/particles): the state, the
tracer/inertia/tinia dynamics and the bil_cloud droplets, the coupled RK
step, the particle files; parallel.py holds the owner-sharded slots of the
rank mesh."""
from tlab_tpu_torch.particles.core import (  # noqa: F401
    ParticleState, ParticleProps, interpolate_to_particles,
    particles_to_field, particle_rhs, init_particles)
