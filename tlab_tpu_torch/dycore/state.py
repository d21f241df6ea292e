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


def stack(state: State) -> torch.Tensor:
    """Q (3+ns, nx, ny, nz) with rows u, v, w, s1.. (a new tensor)."""
    return torch.cat([state.u[None], state.v[None], state.w[None], state.s],
                     dim=0)


def unstack(Q: torch.Tensor, sfc: Optional[torch.Tensor] = None) -> State:
    """State whose components are views into Q."""
    return State(u=Q[0], v=Q[1], w=Q[2], s=Q[3:], sfc=sfc)
