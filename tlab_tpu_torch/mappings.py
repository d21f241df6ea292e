"""Derived-field diagnostics (reference src/mappings/fi_*.f90; port of
tlab_tpu/mappings.py).

3D -> 3D fields built from first derivatives of the state: vorticity,
enstrophy, strain, velocity-gradient invariants (P, Q, R), scalar gradient,
viscous dissipation. Each is a handful of dense-matrix derivative products
+ elementwise algebra on the state's device.
"""
from __future__ import annotations

import torch

from tlab_tpu_torch.dycore import incompressible as dyn


def _grad(P, a):
    return (dyn._d1(P, "x", 0, a), dyn._d1(P, "y", 1, a),
            dyn._d1(P, "z", 2, a))


def velocity_gradient(P, u, v, w):
    """3x3 tensor A_ij = du_i/dx_j as a dict of fields."""
    gu = _grad(P, u)
    gv = _grad(P, v)
    gw = _grad(P, w)
    return {"ux": gu[0], "uy": gu[1], "uz": gu[2],
            "vx": gv[0], "vy": gv[1], "vz": gv[2],
            "wx": gw[0], "wy": gw[1], "wz": gw[2]}


def curl(P, u, v, w):
    """Vorticity (reference FI_CURL, fi_vectorcalculus.f90:20)."""
    return (dyn._d1(P, "y", 1, w) - dyn._d1(P, "z", 2, v),
            dyn._d1(P, "z", 2, u) - dyn._d1(P, "x", 0, w),
            dyn._d1(P, "x", 0, v) - dyn._d1(P, "y", 1, u))


def vorticity_magnitude2(P, u, v, w):
    """Enstrophy density w_i w_i (reference FI_VORTICITY)."""
    ox, oy, oz = curl(P, u, v, w)
    return ox * ox + oy * oy + oz * oz


def strain2(P, u, v, w):
    """s_ij s_ij (reference FI_STRAIN, fi_strain.f90:68-99):
    u,x^2 + v,y^2 + w,z^2 + 1/2[(u,y+v,x)^2 + (u,z+w,x)^2 + (v,z+w,y)^2]."""
    g = velocity_gradient(P, u, v, w)
    diag = g["ux"] ** 2 + g["vy"] ** 2 + g["wz"] ** 2
    off = 0.5 * ((g["uy"] + g["vx"]) ** 2
                 + (g["uz"] + g["wx"]) ** 2
                 + (g["vz"] + g["wy"]) ** 2)
    return diag + off


def invariants(P, u, v, w):
    """Invariants of the velocity-gradient tensor (reference
    FI_INVARIANT_{P,Q,R}, fi_vectorcalculus.f90:111-229):
    P = -tr(A), Q = (P^2 - tr(A^2))/2, R = -det(A)."""
    g = velocity_gradient(P, u, v, w)
    A = [[g["ux"], g["uy"], g["uz"]],
         [g["vx"], g["vy"], g["vz"]],
         [g["wx"], g["wy"], g["wz"]]]
    trA = A[0][0] + A[1][1] + A[2][2]
    trA2 = sum(A[i][j] * A[j][i] for i in range(3) for j in range(3))
    detA = (A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1])
            - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0])
            + A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]))
    inv_p = -trA
    inv_q = 0.5 * (inv_p ** 2 - trA2)
    inv_r = -detA
    return inv_p, inv_q, inv_r


def gradient_magnitude2(P, s):
    """|grad s|^2 (reference FI_GRADIENT)."""
    gx, gy, gz = _grad(P, s)
    return gx * gx + gy * gy + gz * gz


def dissipation(P, u, v, w, visc):
    """Viscous dissipation rate 2 nu s_ij s_ij incompressible
    (reference FI_DISSIPATION)."""
    return 2.0 * visc * strain2(P, u, v, w)


def gate_intermittency(field, threshold):
    """Binary gate field (reference FI_GATE, fi_gate.f90)."""
    return (field > threshold).to(field.dtype)


# ---------------------------------------------------------------------------
# Pointwise evolution-equation fields (the pdfs.x analysis menu): the
# reference FI_*_PRODUCTION / _DIFFUSION / _PRESSURE kernels
# (fi_vorticity.f90, fi_strain.f90, fi_gradient.f90) as fused matmul
# chains.  Viscosity/diffusivity factors are NOT multiplied here (as in
# the reference kernels); callers scale.
# ---------------------------------------------------------------------------

def laplacian(P, a):
    """Compact Laplacian d2x + d2y + d2z (three OPR_P2 applications)."""
    return (dyn._d2(P, "x", 0, a) + dyn._d2(P, "y", 1, a)
            + dyn._d2(P, "z", 2, a))


def vorticity_production(P, u, v, w):
    """w_i w_j S_ij (reference FI_VORTICITY_PRODUCTION,
    fi_vorticity.f90:64-116)."""
    g = velocity_gradient(P, u, v, w)
    wx = g["wy"] - g["vz"]
    wy = g["uz"] - g["wx"]
    wz = g["vx"] - g["uy"]
    return (wx * wx * g["ux"] + wy * wy * g["vy"] + wz * wz * g["wz"]
            + wx * wy * (g["uy"] + g["vx"])
            + wx * wz * (g["uz"] + g["wx"])
            + wy * wz * (g["vz"] + g["wy"]))


def vorticity_diffusion(P, u, v, w):
    """w_i lap(w_i), nu NOT multiplied (reference FI_VORTICITY_DIFFUSION,
    fi_vorticity.f90:122-167)."""
    ox, oy, oz = curl(P, u, v, w)
    return (ox * laplacian(P, ox) + oy * laplacian(P, oy)
            + oz * laplacian(P, oz))


def strain_production(P, u, v, w):
    """-s_ij s_jk s_ki - 1/4 w_i w_j s_ij (reference FI_STRAIN_PRODUCTION,
    fi_strain.f90:113-163)."""
    g = velocity_gradient(P, u, v, w)
    s12 = 0.5 * (g["uy"] + g["vx"])
    s13 = 0.5 * (g["uz"] + g["wx"])
    s23 = 0.5 * (g["vz"] + g["wy"])
    res = 0.25 * vorticity_production(P, u, v, w)
    res = res + 2.0 * s12 * s13 * s23
    res = res + g["ux"] * (g["ux"] ** 2 + 3.0 * (s12 ** 2 + s13 ** 2))
    res = res + g["vy"] * (g["vy"] ** 2 + 3.0 * (s12 ** 2 + s23 ** 2))
    res = res + g["wz"] * (g["wz"] ** 2 + 3.0 * (s13 ** 2 + s23 ** 2))
    return -res


def strain_diffusion(P, u, v, w):
    """s_ij lap(s_ij), nu NOT multiplied (reference FI_STRAIN_DIFFUSION,
    fi_strain.f90:169-249): diagonal terms plus 1/2 (2 s_ab) lap(2 s_ab)
    for each off-diagonal pair."""
    g = velocity_gradient(P, u, v, w)
    res = (g["ux"] * laplacian(P, g["ux"])
           + g["vy"] * laplacian(P, g["vy"])
           + g["wz"] * laplacian(P, g["wz"]))
    for t in (g["uy"] + g["vx"], g["uz"] + g["wx"], g["vz"] + g["wy"]):
        res = res + 0.5 * t * laplacian(P, t)
    return res


def strain_pressure(P, u, v, w, p):
    """-s_ij p,ij (reference FI_STRAIN_PRESSURE, fi_strain.f90:254-304):
    diagonal du_i/dx_i p,ii plus (2 s_ab) p,ab off-diagonal."""
    g = velocity_gradient(P, u, v, w)
    px = dyn._d1(P, "x", 0, p)
    py = dyn._d1(P, "y", 1, p)
    res = (g["ux"] * dyn._d2(P, "x", 0, p)
           + g["vy"] * dyn._d2(P, "y", 1, p)
           + g["wz"] * dyn._d2(P, "z", 2, p))
    res = res + dyn._d1(P, "y", 1, px) * (g["vx"] + g["uy"])
    res = res + dyn._d1(P, "z", 2, px) * (g["wx"] + g["uz"])
    res = res + dyn._d1(P, "z", 2, py) * (g["wy"] + g["vz"])
    return -res


def strain_a(P, a, u, v, w):
    """(strain1, strain2, g2): G_i du_j/dx_i G_j, the same normalized by
    G_k G_k where positive, and G_k G_k (reference FI_STRAIN_A,
    fi_strain.f90:310-362 -- the flamelet 'strain along the scalar
    normal')."""
    n1, n2, n3 = _grad(P, a)
    g = velocity_gradient(P, u, v, w)
    strain1 = (n1 * (n1 * g["ux"] + n2 * g["uy"] + n3 * g["uz"])
               + n2 * (n1 * g["vx"] + n2 * g["vy"] + n3 * g["vz"])
               + n3 * (n1 * g["wx"] + n2 * g["wy"] + n3 * g["wz"]))
    g2 = n1 * n1 + n2 * n2 + n3 * n3
    strain2 = torch.where(g2 > 0.0,
                          strain1 / torch.where(g2 > 0.0, g2, 1.0), strain1)
    return strain1, strain2, g2


def gradient_production(P, s, u, v, w):
    """-G_i G_j S_ij (reference FI_GRADIENT_PRODUCTION,
    fi_gradient.f90:53-94)."""
    gx, gy, gz = _grad(P, s)
    g = velocity_gradient(P, u, v, w)
    return -(gx * gx * g["ux"] + gy * gy * g["vy"] + gz * gz * g["wz"]
             + gx * gy * (g["uy"] + g["vx"])
             + gx * gz * (g["uz"] + g["wx"])
             + gy * gz * (g["vz"] + g["wy"]))


def gradient_diffusion(P, s):
    """G_i lap(G_i), diffusivity NOT multiplied (reference
    FI_GRADIENT_DIFFUSION, fi_gradient.f90:100-133)."""
    gx, gy, gz = _grad(P, s)
    return (gx * laplacian(P, gx) + gy * laplacian(P, gy)
            + gz * laplacian(P, gz))
