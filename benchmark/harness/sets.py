"""What differs between the program's equation sets, in one place.

tools.dns.make_step_functions dispatches on the Simulation: the
incompressible set (and the anelastic one, which shares it) steps a
State (u, v, w, s..), the compressible set, where sim.comp is set, a
CompState (rho, rho u, rho v, rho w, rho e, rho s..).  An entry here gives
what the harness needs of a set: the state's stack and unstack, the names
of the stacked fields, the loop's dt rule from the diagnostics the host
reads, the number of fields, the slots that form one vector (their gaps
share the largest component's scale), whether the reference can judge
the set's statistics, and how check.py judges a step's diagnostics.
cell.py, window.py and check.py ask the entry; nothing here assumes a
precision.
"""
from __future__ import annotations

import math


class Incompressible:
    """tools/dns.py::_run's loop: State (u, v, w, s..), dt from the CFL
    number and the plan's diffusion constant (dycore.incompressible.
    next_dt), diagnostics [CFL, dilatation min, max(, NewtonRs)]."""

    name = "incompressible"
    flow = ("u", "v", "w")
    vector = (0, 1, 2)
    stats = True

    @staticmethod
    def stack(state):
        from tlab_tpu_torch.dycore.state import stack
        return stack(state)

    @staticmethod
    def unstack(q):
        from tlab_tpu_torch.dycore.state import unstack
        return unstack(q)

    @staticmethod
    def next_dt(sim, vals) -> float:
        from tlab_tpu_torch.dycore import incompressible as dyn
        return dyn.next_dt(sim.P, vals[0], sim.case.time_cfl,
                           sim.case.time_cfl_diffusive)

    @staticmethod
    def n_fields(sim) -> int:
        return 3 + sim.nsp.n_scalars

    @staticmethod
    def floors(model, q_old, dt) -> list:
        """No field's change needs a scale below its own."""
        return [0.0] * q_old.shape[0]

    @staticmethod
    def diag_reference(model, ref_new, floors):
        """The diagnostics are judged on the program's own new state."""
        return None

    @staticmethod
    def diag_gap(model, q_new, diag, ref) -> float:
        """The CFL number's relative gap and the dilatation extrema's gap
        over the size of the divergence's terms, the reference's
        diagnostics of the program's new state."""
        (cfl, dmin, dmax, *_), scale = model.diagnostics(q_new)
        return max(abs(diag[0] - cfl) / cfl,
                   max(abs(diag[1] - dmin), abs(diag[2] - dmax)) / scale)


class Compressible:
    """tools/dns.py::_run_compressible's loop: CompState (rho, rho u,
    rho v, rho w, rho e, rho s..), diagnostics [acoustic CFL, PMin, PMax,
    RMin, RMax, dden]."""

    name = "compressible"
    flow = ("rho", "rhou", "rhov", "rhow", "rhoe")
    vector = (1, 2, 3)
    stats = False

    @staticmethod
    def stack(state):
        import torch
        rows = [state.rho[None], state.rhou[None], state.rhov[None],
                state.rhow[None], state.rhoE[None]]
        if state.rhos is not None:
            rows.append(state.rhos)
        return torch.cat(rows, dim=0)

    @staticmethod
    def unstack(q):
        from tlab_tpu_torch.dycore.compressible import CompState
        return CompState(q[0], q[1], q[2], q[3], q[4],
                         q[5:] if q.shape[0] > 5 else None)

    @staticmethod
    def next_dt(sim, vals) -> float:
        """_run_compressible's next_dt (tools/dns.py:1273-1276): the case's
        fixed TimeStep, else min(TimeCFL / cmax, TimeDiffusiveCFL / dden)
        with cmax = vals[0] and dden = vals[-1]."""
        case = sim.case
        if case.time_step > 0:
            return case.time_step
        cmax, dden = vals[0], vals[-1]
        return min(case.time_cfl / cmax if cmax > 0 else math.inf,
                   case.time_cfl_diffusive / dden if dden > 0 else math.inf)

    @staticmethod
    def n_fields(sim) -> int:
        return 5 + sim.nsp.n_scalars

    @staticmethod
    def floors(model, q_old, dt) -> list:
        """rho's change over a step from a uniform density is the
        divergence of a nearly solenoidal mass flux, at float32's
        round-off of rho itself: its scale is at least the size of the
        continuity equation's terms over the step, dt max sum_j
        |d_j(rho u_j)|."""
        return [dt * model.mass_flux_terms(q_old)] \
            + [0.0] * (q_old.shape[0] - 1)

    @staticmethod
    def diag_reference(model, ref_new, floors):
        """The reference's diagnostics of its own new state and their
        scales: rho's range at least the continuity terms' floor."""
        vals, scales = model.diagnostics(ref_new)
        scales[3] = scales[4] = max(scales[3], floors[0])
        return vals, scales

    @staticmethod
    def diag_gap(model, q_new, diag, ref) -> float:
        """The largest of the CFL number's and dden's relative gaps and
        each extremum's gap over its field's range in the box, against the
        reference's diagnostics of its own new state from the same state
        and dt: the diagnostics are pointwise, so only the step's
        precision moves them."""
        vals, scales = ref
        return max(abs(d - r) / s for d, r, s in zip(diag, vals, scales))


def of(sim):
    """The entry of a Simulation's equation set."""
    return Compressible if getattr(sim, "comp", None) is not None \
        else Incompressible


def of_case(ini: dict):
    """The entry of a configuration's case ({section: {key: value}}), by
    its [Main] Equations as Simulation.from_case reads it."""
    from reference.case import Case
    eq = Case(ini).get("Main", "Equations", "incompressible").lower()
    return Compressible if eq in ("compressible", "internal", "total") \
        else Incompressible


def names(eqs, n: int) -> tuple:
    """The names of a stack of n fields of the set: its flow fields, then
    s1, s2, .."""
    return eqs.flow + tuple(f"s{i + 1}" for i in range(n - len(eqs.flow)))
