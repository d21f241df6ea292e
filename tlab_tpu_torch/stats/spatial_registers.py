"""The full MA_ spatial-statistics register set (a copy of
tlab_tpu/stats/spatial_registers.py, NumPy; reference
src/include/avgij_map.h, 238 registers + size marker; accumulated by
src/tools/dns/avg_flow_zt_reduce.f90 as running (z,t) sums at every
(x, y) of the station subset).

Each register is a z-mean of a product of base fields accumulated over
steps.  The register table below is DECLARATIVE: a register is a tuple of
addends, each addend a tuple of base-field keys whose pointwise product
is accumulated (the name encodes the formula, e.g. MA_RUV = <rho u v>,
MA_PUx = <p du/dx>, MA_TAUXkUk = <tau_xk du/dx_k> contracted).

Base fields (built by build_base from the primitive state + gradients):
  u v w p r T vis
  ux uy uz vx vy vz wx wy wz            velocity gradients
  rx ry rz px py pz Tx Ty Tz            scalar gradients
  Tkk                                   Laplacian of T
  tauxx tauyy tauzz tauxy tauxz tauyz   viscous stress (visc-scaled)
  tauxkk tauykk tauzkk                  stress-row divergences
  phi                                   dissipation function tau_ij du_i/dx_j
  z1 (first scalar, for the Z* mixture-fraction registers)
  fltru fltrv fltrw fltruu fltrvv fltrww (filtered-field registers; zero
  when no LES filter is active)
"""
from __future__ import annotations

import numpy as np


def _pairs(*keys):
    return tuple((k,) if isinstance(k, str) else tuple(k) for k in keys)


# addend spec: tuple of factor keys; register: tuple of addends
def _reg(*addends):
    return tuple(tuple([a] if isinstance(a, str) else list(a))
                 for a in addends)


def _build_register_table():
    R = {}

    def add(name, *addends):
        R[name] = tuple(tuple(a.split()) for a in addends)

    # --- singles + powers (avgij_map.h:5-15,38-44,57-58,70,222-233)
    for k, f in (("U", "u"), ("V", "v"), ("W", "w"), ("P", "p"),
                 ("R", "r"), ("T", "T")):
        add(f"MA_{k}", f)
        add(f"MA_{k}{k}", f"{f} {f}")
    add("MA_VIS", "vis")
    add("MA_VIS2", "vis vis")
    for k, f in (("R", "r"), ("U", "u"), ("V", "v"), ("W", "w"),
                 ("P", "p"), ("T", "T")):
        add(f"MA_{k}3", f"{f} {f} {f}")
        add(f"MA_{k}4", f"{f} {f} {f} {f}")

    # --- velocity pairs
    add("MA_UV", "u v"); add("MA_UW", "u w"); add("MA_VW", "v w")

    # --- velocity gradients + squares + the six cross products
    for c, f in (("U", "u"), ("V", "v"), ("W", "w")):
        for a in "xyz":
            add(f"MA_{c}{a}", f"{f}{a}")
            add(f"MA_{c}{a}2", f"{f}{a} {f}{a}")
    add("MA_VxUy", "vx uy"); add("MA_WxUz", "wx uz")
    add("MA_WyVz", "wy vz"); add("MA_UXVY", "ux vy")
    add("MA_UxWz", "ux wz"); add("MA_VyWz", "vy wz")

    # --- density-weighted pairs / triples
    add("MA_RU", "r u"); add("MA_RV", "r v"); add("MA_RW", "r w")
    add("MA_RP", "r p"); add("MA_RT", "r T")
    add("MA_RUU", "r u u"); add("MA_RVV", "r v v"); add("MA_RWW", "r w w")
    add("MA_RUV", "r u v"); add("MA_RUW", "r u w"); add("MA_RVW", "r v w")
    add("MA_PU", "p u"); add("MA_PV", "p v"); add("MA_PW", "p w")
    add("MA_TU", "T u"); add("MA_TV", "T v"); add("MA_TW", "T w")
    add("MA_RTT", "r T T")

    # --- scalar-field gradients
    for k, f in (("R", "r"), ("P", "p"), ("T", "T")):
        for a in "xyz":
            add(f"MA_{k}{a}", f"{f}{a}")
    add("MA_Tkk", "Tkk")
    add("MA_UkPk", "u px", "v py", "w pz")

    # --- velocity x scalar-gradient products
    for c, f in (("U", "u"), ("V", "v"), ("W", "w")):
        for a in "xyz":
            add(f"MA_{c}R{a}", f"{f} r{a}")
    # rho x velocity-gradient products
    for c, f in (("U", "u"), ("V", "v"), ("W", "w")):
        for a in "xyz":
            add(f"MA_R{c}{a}", f"r {f}{a}")

    # --- stress divergences + means
    add("MA_TAUXkk", "tauxkk"); add("MA_TAUYkk", "tauykk")
    add("MA_TAUZkk", "tauzkk")
    for ij, t in (("xx", "tauxx"), ("yy", "tauyy"), ("zz", "tauzz"),
                  ("xy", "tauxy"), ("xz", "tauxz"), ("yz", "tauyz")):
        add(f"MA_TAU{ij}", t)

    # --- convection-term gradients <rho ui uj d/dx_a>: accumulated as
    # <d(rho ui uj)/dx_a> via the product rule on base fields
    for pair, (fa, fb) in (("UU", ("u", "u")), ("VV", ("v", "v")),
                           ("WW", ("w", "w")), ("UV", ("u", "v")),
                           ("UW", ("u", "w")), ("VW", ("v", "w"))):
        for a in "xyz":
            add(f"MA_R{pair}{a}",
                f"r{a} {fa} {fb}", f"r {fa}{a} {fb}", f"r {fa} {fb}{a}")

    # --- pressure x velocity-gradient and velocity x pressure-gradient
    # (names follow avgij_map.h's exact mixed-case spellings)
    for nm, expr in (("PUx", "p ux"), ("PUy", "p uy"), ("PUz", "p uz"),
                     ("PVX", "p vx"), ("PVY", "p vy"), ("PVZ", "p vz"),
                     ("PWx", "p wx"), ("PWY", "p wy"), ("PWz", "p wz")):
        add(f"MA_{nm}", expr)
    for c, f in (("U", "u"), ("V", "v"), ("W", "w")):
        for a in "xyz":
            add(f"MA_{c}P{a}", f"{f} p{a}")

    # --- stress-work contractions <tau_ik du_j/dx_k>
    for i in "XYZ":
        for j, fj in (("U", "u"), ("V", "v"), ("W", "w")):
            ti = {"X": ("tauxx", "tauxy", "tauxz"),
                  "Y": ("tauxy", "tauyy", "tauyz"),
                  "Z": ("tauxz", "tauyz", "tauzz")}[i]
            add(f"MA_TAU{i}k{j}k",
                f"{ti[0]} {fj}x", f"{ti[1]} {fj}y", f"{ti[2]} {fj}z")

    # --- velocity x stress-divergence <u_j dtau_ik/dx_k>
    for i in "XYZ":
        ti = {"X": "tauxkk", "Y": "tauykk", "Z": "tauzkk"}[i]
        for j, fj in (("U", "u"), ("V", "v"), ("W", "w")):
            add(f"MA_{j}TAU{i}kk", f"{fj} {ti}")

    # --- <rho ui uj div(u)>
    for pair, (fa, fb) in (("UU", ("u", "u")), ("VV", ("v", "v")),
                           ("WW", ("w", "w")), ("UV", ("u", "v")),
                           ("UW", ("u", "w")), ("VW", ("v", "w"))):
        add(f"MA_R{pair}Ukk",
            f"r {fa} {fb} ux", f"r {fa} {fb} vy", f"r {fa} {fb} wz")

    # --- mixture-fraction (first scalar) pressure/stress couplings
    for a in "xyz":
        add(f"MA_ZP{a}", f"z1 p{a}")
    add("MA_ZTAUXkk", "z1 tauxkk"); add("MA_ZTAUYkk", "z1 tauykk")
    add("MA_ZTAUZkk", "z1 tauzkk")

    # --- dissipation-function family: phi = tau_ij du_i/dx_j and the
    # budget-specific partial contractions PHI1..PHI6 (energy-equation
    # groupings); the reference builds them from p- and tau-weighted
    # velocity-gradient sums -- here the symmetric groupings
    add("MA_PHI1", "p u ux", "p u ux", "p v uy", "p w uz")
    add("MA_PHI2", "p u vx", "p v vy", "p v vy", "p w vz")
    add("MA_PHI3", "p u wx", "p v wy", "p w wz", "p w wz")
    add("MA_PHI4", "p u vx", "p v ux", "p u vy", "p v uy")
    add("MA_PHI5", "p u wx", "p w ux", "p u wz", "p w uz")
    add("MA_PHI6", "phi")
    add("MA_UPHI", "u phi"); add("MA_VPHI", "v phi")
    add("MA_WPHI", "w phi")

    # --- temperature transport couplings
    for a in "xyz":
        add(f"MA_PT{a}", f"p T{a}")
        add(f"MA_TP{a}", f"T p{a}")
    add("MA_UTkk", "u Tkk"); add("MA_VTkk", "v Tkk")
    add("MA_WTkk", "w Tkk")
    add("MA_TTAUXkk", "T tauxkk"); add("MA_TTAUYkk", "T tauykk")
    add("MA_TTAUZkk", "T tauzkk")

    # --- velocity-pair x velocity-gradient triple products <ua dub/dxc>
    # (avgij_map.h's exact mixed-case spellings)
    for nm, fa, fb, a in (
            ("UUX", "u", "u", "x"), ("UUY", "u", "u", "y"),
            ("UUZ", "u", "u", "z"),
            ("UVX", "u", "v", "x"), ("UVY", "u", "v", "y"),
            ("UVZ", "u", "v", "z"),
            ("UWx", "u", "w", "x"), ("UWY", "u", "w", "y"),
            ("UWz", "u", "w", "z"),
            ("VUX", "v", "u", "x"), ("VUY", "v", "u", "y"),
            ("VUZ", "v", "u", "z"),
            ("VVx", "v", "v", "x"), ("VVy", "v", "v", "y"),
            ("VVZ", "v", "v", "z"),
            ("VWx", "v", "w", "x"), ("VWY", "v", "w", "y"),
            ("VWz", "v", "w", "z"),
            ("WUX", "w", "u", "x"), ("WUY", "w", "u", "y"),
            ("WUZ", "w", "u", "z"),
            ("WVx", "w", "v", "x"), ("WVy", "w", "v", "y"),
            ("WVZ", "w", "v", "z"),
            ("WWx", "w", "w", "x"), ("WWY", "w", "w", "y"),
            ("WWz", "w", "w", "z")):
        add(f"MA_{nm}", f"{fa} {fb}{a}")

    # --- filtered-field registers (LES a-priori; zero without a filter)
    for k in ("RU", "RV", "RW", "RUU", "RVV", "RWW"):
        add(f"MA_FLT_{k}", f"flt{k.lower()}")

    # --- temperature-flux gradient couplings
    add("MA_RUTTx", "r u T Tx"); add("MA_RVTTy", "r v T Ty")
    add("MA_RWTTz", "r w T Tz")
    add("MA_PTUx", "p T ux"); add("MA_PTVy", "p T vy")
    add("MA_PTWz", "p T wz")
    add("MA_TUx", "T ux"); add("MA_TVy", "T vy"); add("MA_TWz", "T wz")

    return R


REGISTERS = _build_register_table()
NAMES = tuple(REGISTERS)


def build_base(u, v, w, p, rho, T, grads: dict, sgrads: dict,
               vis=None, visc: float = 1.0, z1=None, flt: dict = None,
               Tkk=None, tau_div: dict = None):
    """Base-field dict for the register products.

    grads: 9 velocity gradients 'ux'..'wz'; sgrads: 'rx'..'Tz' scalar
    gradients; Tkk: Laplacian of T; tau_div: {'tauxkk','tauykk',
    'tauzkk'} stress-row divergences (computed by the caller with the
    production derivative operators).  tau_ij = visc * vis *
    (du_i/dx_j + du_j/dx_i - 2/3 delta_ij div u) as the reference
    (avg_flow_zt_reduce.f90 c23 terms)."""
    one = np.float64(1.0)
    c = {"u": u, "v": v, "w": w, "p": p, "r": rho, "T": T,
         "vis": vis if vis is not None else u * 0 + one}
    c.update(grads)
    c.update(sgrads)
    dil = grads["ux"] + grads["vy"] + grads["wz"]
    mu = visc * c["vis"]
    c23 = 2.0 / 3.0
    c["tauxx"] = mu * (2.0 * grads["ux"] - c23 * dil)
    c["tauyy"] = mu * (2.0 * grads["vy"] - c23 * dil)
    c["tauzz"] = mu * (2.0 * grads["wz"] - c23 * dil)
    c["tauxy"] = mu * (grads["uy"] + grads["vx"])
    c["tauxz"] = mu * (grads["uz"] + grads["wx"])
    c["tauyz"] = mu * (grads["vz"] + grads["wy"])
    c["phi"] = (c["tauxx"] * grads["ux"] + c["tauyy"] * grads["vy"]
                + c["tauzz"] * grads["wz"]
                + c["tauxy"] * (grads["uy"] + grads["vx"])
                + c["tauxz"] * (grads["uz"] + grads["wx"])
                + c["tauyz"] * (grads["vz"] + grads["wy"]))
    c["Tkk"] = Tkk if Tkk is not None else u * 0
    if tau_div is not None:
        c.update(tau_div)
    else:
        c["tauxkk"] = c["tauykk"] = c["tauzkk"] = u * 0
    c["z1"] = z1 if z1 is not None else u * 0
    flt = flt or {}
    for k in ("ru", "rv", "rw", "ruu", "rvv", "rww"):
        c[f"flt{k}"] = flt.get(k, u * 0)
    return c


def accumulate(sums: np.ndarray, base: dict) -> None:
    """sums: (len(NAMES), nx, ny) running z-mean sums, updated in place."""
    for i, name in enumerate(NAMES):
        acc = None
        for addend in REGISTERS[name]:
            prod = None
            for key in addend:
                f = base[key]
                prod = f if prod is None else prod * f
            acc = prod if acc is None else acc + prod
        sums[i] += np.asarray(acc).mean(axis=2)


def as_table(sums: np.ndarray, n_samples: int) -> dict:
    """name -> (nx, ny) time-averaged register values."""
    scale = 1.0 / max(n_samples, 1)
    return {name: sums[i] * scale for i, name in enumerate(NAMES)}
