"""Coupled flow+particle RK stepping (port of tlab_tpu/particles/stepping.py;
reference TIME_SUBSTEP_PARTICLE, time.f90:906-1011): particles advance with
the same low-storage scheme, interpolating the current velocity each
substep.

The flow goes through the stacked carry (substep_rhs_stacked, so K1-K3
launch where their gate holds), and only through what tlab_tpu's particle
step does: tendency, q += dte h, h *= kco.  tlab_tpu's step calls its
unstacked substep_rhs and so skips what its rk_step adds around each
substep: the wall values pinned before the step, the scalar clip
(ScalLimit), the interactive surface, the immersed boundary's direct
forcing and the creation of the surface state.  The port reproduces that
(ROADMAP C 28): it does not reuse _rk_core_stacked.
"""
from __future__ import annotations

from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.state import State, stack, unstack
from tlab_tpu_torch.particles import bil_cloud as bc
from tlab_tpu_torch.particles.core import (ParticleProps, ParticleState,
                                           particle_rhs, wrap_positions)


def rk_step_with_particles(P, grid, locate, pprops: ParticleProps,
                           state: State, pstate: ParticleState, dtime):
    """One RK step of the flow and the particles; returns (state, pstate).

    A substep, in the reference's order: the particles' tendency from the
    velocity before the substep (and the droplets' from the Eulerian
    sources of the current state), the particles moved and wrapped, then
    the flow's substep; the particles' tendencies scale by kco with the
    flow's.  After the step the bil_cloud liquid is clipped at 0 and
    variant 4 advances its residence clocks."""
    kdt = P["rk"]["kdt"]
    kco = P["rk"]["kco"]
    bil = pprops.bil_cloud if pprops.type.startswith("bil_cloud") else None
    # the Eulerian radiation feeds the droplet equations (reference
    # rhs_part_1.f90:82-86); make_sources exposes the closure
    ir_field = getattr(P.get("bodyforce"), "ir_field", None)
    Q = stack(state)
    H = Q.new_zeros(Q.shape)
    hpx = pstate.x.new_zeros(pstate.x.shape)
    hpv = pstate.v.new_zeros(pstate.v.shape)
    hpp = pstate.props.new_zeros(pstate.props.shape) if bil is not None \
        else None
    last = len(kdt) - 1
    for i, k in enumerate(kdt):
        dte = dtime * k
        # particles first, from the pre-substep velocity (reference order)
        dpx, dpv = particle_rhs(pprops, pstate, locate, Q[0], Q[1], Q[2])
        hpx = hpx + dpx
        hpv = hpv + dpv
        props = pstate.props
        if bil is not None:
            # droplet-scalar sources from the CURRENT Eulerian state
            # (reference RHS_PART_1 computes txc fields inside the substep)
            now = unstack(Q, state.sfc)
            rad = ir_field(now) if ir_field is not None else None
            src = bc.eulerian_sources(P, now.s, P["visc"], bil,
                                      radiation=rad)
            drhs = bc.droplet_rhs(bil, src, locate(pstate.x))
            # props narrower than 2 columns take no droplet tendency (as
            # tlab_tpu's .at[:, :2].add; dns.run pads them to n_props)
            w = min(2, hpp.shape[1])
            hpp[:, :w] += drhs[:, :w]
            props = props + dte * hpp
        pstate = ParticleState(x=wrap_positions(grid, pstate.x + dte * hpx),
                               v=pstate.v + dte * hpv, props=props,
                               tags=pstate.tags)
        # the flow's substep
        H, _ = dyn.substep_rhs_stacked(P, Q, H, dte)
        Q = Q + dte * H
        if i < last:
            H.mul_(kco[i])
            hpx = kco[i] * hpx
            hpv = kco[i] * hpv
            if bil is not None:
                hpp = kco[i] * hpp
    if bil is not None:
        # post-step bookkeeping (reference time.f90:250-258): clip negative
        # liquid; variant 4 advances the residence-time clocks
        props = pstate.props.clone()
        props[:, :2] = bc.liquid_clip(props[:, :2])
        if bil.variant >= 4 and props.shape[1] >= 4:
            props[:, 2:4] = bc.residence_update(bil, dtime, pstate.x[:, 1],
                                                props[:, 2:4])
        pstate = pstate._replace(props=props)
    return unstack(Q, state.sfc), pstate
