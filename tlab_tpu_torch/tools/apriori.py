"""A-priori LES analysis: filtered-DNS subgrid diagnostics
(reference src/tools/structure/apriori.f90; port of
tlab_tpu/tools/apriori.py).

From a DNS snapshot and a test filter G: subgrid stresses
tau_ij = G(u_i u_j) - G(u_i) G(u_j), their plane statistics, and the
Smagorinsky-coefficient diagnostic from the resolved strain.  Every
profile stays on the fields' device; the caller copies the table.
"""
from __future__ import annotations

import torch

from tlab_tpu_torch import mappings
from tlab_tpu_torch.ops.filter import apply_filter
from tlab_tpu_torch.stats.averages import _pavg


def subgrid_stress(mats, u, v, w):
    """(dict of tau_ij fields, dict of the filtered velocities) for the
    test filter `mats`."""
    comps = {"u": u, "v": v, "w": w}
    filt = {k: apply_filter(mats, a) for k, a in comps.items()}
    tau = {}
    for a, b in (("u", "u"), ("v", "v"), ("w", "w"),
                 ("u", "v"), ("u", "w"), ("v", "w")):
        tau[a + b] = apply_filter(mats, comps[a] * comps[b]) \
            - filt[a] * filt[b]
    return tau, filt


def apriori_statistics(P, mats, state, delta: float) -> dict:
    """Plane profiles: subgrid TKE, subgrid dissipation against the resolved
    strain, and the implied Smagorinsky coefficient."""
    tau, filt = subgrid_stress(mats, state.u, state.v, state.w)
    k_sgs = 0.5 * (tau["uu"] + tau["vv"] + tau["ww"])

    g = mappings.velocity_gradient(P, filt["u"], filt["v"], filt["w"])
    S = {"uu": g["ux"], "vv": g["vy"], "ww": g["wz"],
         "uv": 0.5 * (g["uy"] + g["vx"]),
         "uw": 0.5 * (g["uz"] + g["wx"]),
         "vw": 0.5 * (g["vz"] + g["wy"])}
    smag2 = torch.sqrt(2.0 * (S["uu"] ** 2 + S["vv"] ** 2 + S["ww"] ** 2
                              + 2 * (S["uv"] ** 2 + S["uw"] ** 2
                                     + S["vw"] ** 2)))
    # subgrid dissipation eps_sgs = -tau_ij S_ij (deviatoric part)
    tau_dev = dict(tau)
    trace = (tau["uu"] + tau["vv"] + tau["ww"]) / 3.0
    for k in ("uu", "vv", "ww"):
        tau_dev[k] = tau[k] - trace
    eps_sgs = -(tau_dev["uu"] * S["uu"] + tau_dev["vv"] * S["vv"]
                + tau_dev["ww"] * S["ww"]
                + 2 * (tau_dev["uv"] * S["uv"] + tau_dev["uw"] * S["uw"]
                       + tau_dev["vw"] * S["vw"]))

    out = {"Ksgs": _pavg(k_sgs), "EpsSgs": _pavg(eps_sgs),
           "Tauuv": _pavg(tau["uv"]), "Snorm": _pavg(smag2)}
    # Cs^2 Delta^2 from <eps_sgs> = (Cs Delta)^2 <|S|^3>
    s3 = _pavg(smag2 ** 3)
    out["Cs2"] = out["EpsSgs"] / (torch.clamp(s3, min=1e-30) * delta ** 2)
    return out


def filtered_gradients(P, mats, state) -> dict:
    """ParamStructure mode 2 (apriori.f90:296-340): the nine filtered
    velocity derivatives G(du_i/dx_j) as plane profiles (mean + variance),
    tagged Ux..Wz as the reference's gradU<it> table."""
    g = mappings.velocity_gradient(P, state.u, state.v, state.w)
    out = {}
    for tag, key in (("Ux", "ux"), ("Uy", "uy"), ("Uz", "uz"),
                     ("Vx", "vx"), ("Vy", "vy"), ("Vz", "vz"),
                     ("Wx", "wx"), ("Wy", "wy"), ("Wz", "wz")):
        f = apply_filter(mats, g[key])
        out[tag] = _pavg(f)
        out[tag + "2"] = _pavg(f * f)
    return out
