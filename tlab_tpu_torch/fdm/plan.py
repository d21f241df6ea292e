"""FDM derivative plans: per-direction dense operators.

A plan precomputes, in float64 NumPy, everything a derivative application
needs at runtime: the dense matrices D1 (per boundary-condition case) and D2
such that

    df/dx  = D1 @ f      (along the plan's direction)
    d2f/dx2 = D2 @ f

plus the raw compact systems (A, B, C) used by the elliptic solver to build
lambda-dependent pencils, and the modified wavenumbers for periodic
directions.

This replaces the reference's banded-LU plan type fdm_dt / fdm_derivative_dt
(src/fdm/fdm.f90:14-29, src/fdm/fdm_derivative.f90:16-29) with a dense,
MXU-friendly representation: on TPU a compact derivative is one batched
matmul instead of a banded matvec + Thomas sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tlab_tpu_torch.constants import BC
from tlab_tpu_torch.fdm import schemes
from tlab_tpu_torch.grid import Axis


@dataclasses.dataclass(frozen=True)
class DerivPlan:
    """Dense derivative operators along one direction."""

    size: int
    periodic: bool
    uniform: bool
    nodes: np.ndarray
    scale: float
    jac: np.ndarray            # dx/ds (physical grid spacing), shape (n,)
    d1: dict                   # BC -> (n, n) first-derivative matrix
    d2: dict                   # BC -> (n, n) second-derivative matrix
    d12: dict                  # BC -> (2n, n) stacked [D1; D2] for fused apply
    mwn1: Optional[np.ndarray]  # modified wavenumber of D1, physical units
    mwn2: Optional[np.ndarray]  # modified wavenumber of D2 (>=0), physical units
    # raw compact systems (for elliptic pencils)
    A1: np.ndarray
    B1: np.ndarray
    A2: np.ndarray
    B2: np.ndarray
    C2: np.ndarray
    scheme1: schemes.SchemeDef = dataclasses.field(repr=False, default=None)
    scheme2: schemes.SchemeDef = dataclasses.field(repr=False, default=None)


def _uniform_jacobians(nodes: np.ndarray, s1: schemes.SchemeDef,
                       s2: schemes.SchemeDef):
    """Compute dx/ds and d2x/ds2 on the computational (uniform) grid.

    Bootstrap exactly like reference FDM_CreatePlan (fdm.f90:190-233): apply
    the *non-periodic* compact derivative on a unit-spaced grid to the node
    positions.
    """
    n = nodes.shape[0]
    ones = np.ones(n)
    A, B = schemes.build_1der_system(s1, ones, periodic=False)
    jac1 = np.linalg.solve(A, B @ nodes)
    A2u, B2u, C2u = schemes.build_2der_system(s2, ones, np.zeros(n),
                                              periodic=False)
    D1u = np.linalg.solve(A, B)
    D2u = np.linalg.solve(A2u, B2u + C2u @ D1u)
    jac2 = D2u @ nodes
    return jac1, jac2


def build_deriv_plan(axis: Axis, scheme_name1: str = "CompactJacobian6",
                     scheme_name2: str = "CompactJacobian6Hyper") -> DerivPlan:
    n = axis.size
    if n == 1:
        eye0 = np.zeros((1, 1))
        return DerivPlan(size=1, periodic=axis.periodic, uniform=True,
                         nodes=axis.nodes, scale=axis.scale,
                         jac=np.ones(1),
                         d1={bc: eye0 for bc in BC}, d2={bc: eye0 for bc in BC},
                         d12={bc: np.zeros((2, 1)) for bc in BC},
                         mwn1=np.zeros(1), mwn2=np.zeros(1),
                         A1=eye0, B1=eye0, A2=eye0, B2=eye0, C2=eye0)

    s1 = schemes.d1_scheme(scheme_name1)
    s2 = schemes.d2_scheme(scheme_name2)
    jac1, jac2 = _uniform_jacobians(axis.nodes, s1, s2)

    # [Main] SpaceOrder(2)=CompactDirect4/6: nonuniform-native schemes
    # built from the actual nodes with no Jacobian/D1 correction
    # (reference FDM_ComX_Direct, fdm_derivative.f90 CompactDirect
    # branches); on uniform/periodic axes they reduce to the Jacobian
    # coefficients, so the standard build is used there
    stretched = not axis.uniform and not axis.periodic
    direct1 = scheme_name1.lower().startswith("compactdirect") and stretched
    direct2 = scheme_name2.lower().startswith("compactdirect") and stretched

    if direct1:
        A1, B1 = schemes.build_1der_direct_system(axis.nodes)
    else:
        A1, B1 = schemes.build_1der_system(s1, jac1, periodic=axis.periodic)
    if direct2:
        A2, B2 = schemes.build_2der_direct_system(axis.nodes)
        C2 = np.zeros_like(A2)
    else:
        A2, B2, C2 = schemes.build_2der_system(s2, jac1, jac2,
                                               periodic=axis.periodic)

    d1 = {}
    d1[BC.DD] = np.linalg.solve(A1, B1)
    if not axis.periodic:
        d1[BC.ND] = schemes.reduce_neumann(A1, B1, True, False)
        d1[BC.DN] = schemes.reduce_neumann(A1, B1, False, True)
        d1[BC.NN] = schemes.reduce_neumann(A1, B1, True, True)
    else:
        d1[BC.ND] = d1[BC.DN] = d1[BC.NN] = d1[BC.DD]

    # second derivative: Jacobian correction couples D2 to D1 on nonuniform
    # grids (cf. reference FDM_Der2_Solve need_1der, fdm_derivative.f90:437-440)
    d2_base = np.linalg.solve(A2, B2)
    d2_corr = np.linalg.solve(A2, C2) \
        if (not axis.uniform and not direct2) else None
    d2 = {}
    for bc, D1bc in d1.items():
        if d2_corr is None:
            d2[bc] = d2_base
        else:
            d2[bc] = d2_base + d2_corr @ D1bc

    d12 = {bc: np.concatenate([d1[bc], d2[bc]], axis=0) for bc in d1}

    if axis.periodic:
        h = jac1[0]
        mwn1 = schemes.modified_wavenumber_1(s1, n) / h
        mwn2 = schemes.modified_wavenumber_2(s2, n) / h ** 2
    else:
        mwn1 = mwn2 = None

    return DerivPlan(size=n, periodic=axis.periodic, uniform=axis.uniform,
                     nodes=axis.nodes, scale=axis.scale, jac=jac1,
                     d1=d1, d2=d2, d12=d12, mwn1=mwn1, mwn2=mwn2,
                     A1=A1, B1=B1, A2=A2, B2=B2, C2=C2,
                     scheme1=s1, scheme2=s2)


@dataclasses.dataclass(frozen=True)
class FdmPlan:
    """Derivative plans along the three directions."""

    x: DerivPlan
    y: DerivPlan
    z: DerivPlan

    def axis(self, i: int) -> DerivPlan:
        return (self.x, self.y, self.z)[i]


def build_fdm_plan(grid, scheme1: str = "CompactJacobian6",
                   scheme2: str = "CompactJacobian6Hyper") -> FdmPlan:
    return FdmPlan(
        x=build_deriv_plan(grid.x, scheme1, scheme2),
        y=build_deriv_plan(grid.y, scheme1, scheme2),
        z=build_deriv_plan(grid.z, scheme1, scheme2),
    )
