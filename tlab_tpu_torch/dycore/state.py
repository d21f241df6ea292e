"""Prognostic state: component tensors and the stacked carry."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class State(NamedTuple):
    """Velocity components (nx, ny, nz) and scalars (ns, nx, ny, nz).

    sfc: the (2, ns, nx, nz) interactive-surface state of the reference
    (boundary_bcs.f90:478-545); the main path carries it untouched."""

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    s: torch.Tensor
    sfc: Optional[torch.Tensor] = None


def zero_state(nx: int, ny: int, nz: int, n_scalars: int = 1,
               dtype=torch.float32, device="cuda") -> State:
    """The state at rest: zero velocities and `n_scalars` zero scalars.
    u, v and w are one tensor, as tlab_tpu's (replace a component, do not
    write into it)."""
    z = torch.zeros((nx, ny, nz), dtype=dtype, device=device)
    return State(u=z, v=z, w=z, s=torch.zeros((n_scalars, nx, ny, nz),
                                              dtype=dtype, device=device))


def stack(state: State) -> torch.Tensor:
    """Q (3+ns, nx, ny, nz) with rows u, v, w, s1.. (a new tensor)."""
    return torch.cat([state.u[None], state.v[None], state.w[None], state.s],
                     dim=0)


def unstack(Q: torch.Tensor, sfc: Optional[torch.Tensor] = None) -> State:
    """State whose components are views into Q."""
    return State(u=Q[0], v=Q[1], w=Q[2], s=Q[3:], sfc=sfc)
