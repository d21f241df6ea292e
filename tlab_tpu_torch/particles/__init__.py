"""Lagrangian particles (port of tlab_tpu/particles): the state, the
tracer/inertia/tinia dynamics and the bil_cloud droplets, the coupled RK
step, the particle files.  The owner-sharded multi-device particles are
ROADMAP A17."""
from tlab_tpu_torch.particles.core import (  # noqa: F401
    ParticleState, ParticleProps, interpolate_to_particles,
    particles_to_field, particle_rhs, init_particles)
