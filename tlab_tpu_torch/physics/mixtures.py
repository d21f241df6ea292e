"""Multi-species mixture thermodynamics: the reference's full MIXT_TYPE
family (thermodynamics.f90:34-48) beyond the moist-air mixtures handled in
physics/thermo.py -- combustion mixtures (Burke-Schumann methane, Peters
methane mechanisms, unimolecular/one-step model flames, Bilger), plus
CHEMKIN NASA-polynomial data files.

The caloric model is the CHEMKIN convention the reference documents
(thermodynamics.f90:305-330; Burcat & Ruscic):

  cp_i(T) = sum_{k=1..NCP} a_k T^{k-1}
  h_i(T)  = sum_{k=1..NCP} a_k T^k / k + a_6
  s_i(T)  = a_1 ln T + sum_{k=2..NCP} a_k T^{k-1}/(k-1) + a_7

with a_6/a_7 fixed from the formation enthalpy/entropy at T_ref. All
species data are published physical constants (molar masses; formation
enthalpies/entropies and linear-cp fits from standard tables, the same
values the reference hardcodes at thermodynamics.f90:340-430).

Port of tlab_tpu/physics/mixtures.py: the species data, build_mixture and
read_chemkin are its NumPy code, copied; the field evaluations are torch
operations over stacked mass-fraction tensors Y of shape (nsp, ...), on the
fields' device and in their dtype (the tables are cast to it where used).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

RGAS = 8314.0          # J / (K kmol), as the reference (thermodynamics.f90)
TREF = 298.0           # K reference temperature for nondimensionalization
PREF = 1.0e5           # Pa


# ---------------------------------------------------------------------------
# Species / mixture definitions (thermodynamics.f90:217-330)
# molar masses in kg/kmol; href (J/kmol), sref (J/(K kmol)),
# cp polynomial coefficients (a1, a2) in J/(kmol K) for cp = a1 + a2 T
# (the reference's fits are linear in T for the model-flame mixtures).
# ---------------------------------------------------------------------------

_TREF_DATA = 298.0     # K, anchor of the formation data below

# name -> (W, href, sref, (cp_a1_at_0, cp_a2)); molar (per kmol) data
_COMBUSTION_SPECIES = {
    "CH4": (16.0, -74.0e6, 186.37e3, (35.70e3 - 42.4833 * _TREF_DATA, 42.4833)),
    "O2": (32.0, 0.0, 205.15e3, (28.96e3 - 6.21666 * _TREF_DATA, 6.21666)),
    "H2O": (18.0, -241.82e6, 188.83e3, (32.76e3 - 11.9570 * _TREF_DATA, 11.9570)),
    "CO2": (44.0, -393.51e6, 213.78e3, (37.22e3 - 17.6500 * _TREF_DATA, 17.6500)),
    "N2": (28.0, 0.0, 191.61e3, (28.88e3 - 4.70833 * _TREF_DATA, 4.70833)),
    # species of the Peters mechanisms without dedicated fit data in the
    # reference (caloric data expected from a chemkin file); constant-cp
    # placeholders at the diatomic/monatomic ideal values
    "CO": (28.0, -110.53e6, 197.66e3, (29.1e3, 0.0)),
    "H2": (2.0, 0.0, 130.68e3, (28.8e3, 0.0)),
    "H": (1.0, 217.998e6, 114.72e3, (20.786e3, 0.0)),
    # model-flame pseudo-species (thermodynamics.f90:386-404)
    "Reactant": (32.0, 0.0, 205.15e3, (29.099e3, 0.0)),
    "Oxidizer": (32.0, 0.0, 205.15e3, (29.099e3, 0.0)),
    "Product32": (32.0, -86.71502e6, 205.15e3, (29.099e3, 0.0)),
    "Inert": (32.0, 0.0, 205.15e3, (29.099e3, 0.0)),
}

# mixture -> ordered species names (last one is the passive/balance species)
MIXTURES = {
    # Burke-Schumann methane: equilibrium chemistry on a mixture fraction
    "bs": ("CH4", "O2", "H2O", "CO2", "N2"),
    "quasibs": ("CH4", "O2", "H2O", "CO2", "N2"),
    # Peters 1988/1991 reduced methane mechanisms
    "peters1988": ("CH4", "O2", "H2O", "CO2", "CO", "H2", "H", "N2"),
    "peters1991": ("CH4", "O2", "H2O", "CO2", "CO", "H2", "H", "N2"),
    "bilger1997": ("CH4", "O2", "H2O", "CO2", "N2"),
    # model flames
    "unidecomp": ("Reactant", "Product32"),
    "onestep": ("Reactant", "Oxidizer", "Product32", "Inert"),
}


@dataclasses.dataclass(frozen=True)
class MixtureTable:
    """Per-species thermal + caloric data, optionally nondimensionalized
    by (CPREF, TREF) with gas constants by RREF (thermodynamics.f90:
    498-540)."""

    name: str
    species: tuple            # species names, length nsp
    W: np.ndarray             # (nsp,) molar masses kg/kmol
    R: np.ndarray             # (nsp,) specific gas constants (maybe /RREF)
    ai: np.ndarray            # (7, nsp) caloric coefficients, mass-specific
    ncp: int                  # polynomial order of cp
    tref: float               # reference T (K)
    cpref: float              # reference cp (J/kg/K), of species ISPREF
    rref: float               # reference R (J/kg/K)
    gama0: float              # cpref / (cpref - rref)
    nondimensional: bool

    @property
    def nsp(self) -> int:
        return len(self.species)


def build_mixture(name: str, nondimensional: bool = True,
                  ispref: int = 1) -> MixtureTable:
    """Assemble the caloric table for a named mixture.

    ispref: 0-based index of the reference species (the reference uses
    species 2, i.e. index 1 -- thermodynamics.f90 ISPREF)."""
    key = name.lower()
    if key not in MIXTURES:
        raise ValueError(f"unknown mixture {name!r}; "
                         f"available: {sorted(MIXTURES)}")
    names = MIXTURES[key]
    nsp = len(names)
    W = np.array([_COMBUSTION_SPECIES[s][0] for s in names])
    href = np.array([_COMBUSTION_SPECIES[s][1] for s in names])
    sref = np.array([_COMBUSTION_SPECIES[s][2] for s in names])
    a12 = np.array([_COMBUSTION_SPECIES[s][3] for s in names])  # (nsp, 2)

    ai = np.zeros((7, nsp))
    ai[0] = a12[:, 0]
    ai[1] = a12[:, 1]
    ncp = 2 if np.any(ai[1] != 0.0) else 1
    # a6/a7 from formation data at TREF (thermodynamics.f90:440-444)
    tr = _TREF_DATA
    ai[5] = href - ai[0] * tr - 0.5 * ai[1] * tr * tr
    ai[6] = sref - ai[1] * tr
    # molar -> mass-specific (J/kg...)
    ai = ai / W[None, :]

    R = RGAS / W
    rref = R[ispref]
    cpref = 0.0
    for icp in range(ncp - 1, -1, -1):
        cpref = cpref * TREF + ai[icp, ispref]
    gama0 = cpref / (cpref - rref)

    if nondimensional:
        R = R / rref
        ai = ai.copy()
        ai[5] = ai[5] / (cpref * TREF)
        ai[6] = ai[6] / cpref
        for icp in range(ncp):
            ai[icp] = ai[icp] * TREF ** icp / cpref

    return MixtureTable(name=key, species=tuple(names), W=W, R=R, ai=ai,
                        ncp=ncp, tref=TREF, cpref=cpref, rref=rref,
                        gama0=gama0, nondimensional=nondimensional)


# ---------------------------------------------------------------------------
# Field evaluations (Y: (nsp, ...) mass fractions; T: (...) temperature in
# the table's units -- T/TREF when nondimensional)
# ---------------------------------------------------------------------------

def _coef(row, T):
    """A (nsp,) table row as a tensor of T's dtype and device, shaped to
    broadcast against (nsp,) + T.shape."""
    return torch.as_tensor(np.asarray(row, np.float64)).to(
        T.device, T.dtype)[(...,) + (None,) * T.ndim]


def cp_species(table: MixtureTable, T):
    """(nsp, ...) per-species cp(T)."""
    a = table.ai
    out = T.new_zeros((table.nsp,) + T.shape)
    for icp in range(table.ncp - 1, -1, -1):
        out = out * T[None] + _coef(a[icp], T)
    return out


def h_species(table: MixtureTable, T):
    """(nsp, ...) per-species enthalpy h_i(T) = int cp dT + a6."""
    a = table.ai
    out = T.new_zeros((table.nsp,) + T.shape)
    for icp in range(table.ncp - 1, -1, -1):
        out = out * T[None] + _coef(a[icp] / (icp + 1.0), T)
    out = out * T[None] + _coef(a[5], T)
    return out


def entropy_species(table: MixtureTable, T):
    """(nsp, ...) per-species thermal entropy s_i(T) (no pressure term)."""
    a = table.ai
    out = _coef(a[0], T) * torch.log(T)[None]
    pw = torch.ones_like(T)
    for icp in range(1, table.ncp):
        pw = pw * T
        out = out + _coef(a[icp] / icp, T) * pw[None]
    return out + _coef(a[6], T)


def cp_mixture(table: MixtureTable, T, Y):
    return torch.sum(cp_species(table, T) * Y, dim=0)


def h_mixture(table: MixtureTable, T, Y):
    return torch.sum(h_species(table, T) * Y, dim=0)


def gas_constant(table: MixtureTable, Y):
    R = torch.as_tensor(np.asarray(table.R, np.float64)).to(Y.device,
                                                            Y.dtype)
    return torch.sum(R[(...,) + (None,) * (Y.ndim - 1)] * Y, dim=0)


def gamma_mixture(table: MixtureTable, T, Y):
    """Local cp/cv; unit-aware: for nondimensional tables cp is scaled
    by CPREF but R by RREF, so R must be rescaled by rref/cpref =
    (gama0-1)/gama0 before subtracting (thermodynamics.f90 GRATIO)."""
    cp = cp_mixture(table, T, Y)
    R = gas_constant(table, Y)
    if table.nondimensional:
        R = R * (table.gama0 - 1.0) / table.gama0
    return cp / (cp - R)


def temperature_from_enthalpy(table: MixtureTable, h, Y, T0=None,
                              n_newton: int = 6):
    """Invert h(T, Y) = h for T by Newton iteration (cp > 0 everywhere;
    quadratic h(T) for the linear-cp mixtures converges in 2-3 steps).
    The reference solves the same scalar inversion inside
    THERMO_CALORIC_TEMPERATURE (thermo_caloric.f90:157-197)."""
    T = torch.full_like(h, 1.0 if table.nondimensional else table.tref) \
        if T0 is None else T0
    for _ in range(n_newton):
        res = h_mixture(table, T, Y) - h
        T = T - res / cp_mixture(table, T, Y)
    return T


# ---------------------------------------------------------------------------
# CHEMKIN thermodynamic data files (MIXT_TYPE_CHEMKIN, THERMO_READ_CHEMKIN)
# ---------------------------------------------------------------------------

_ATOMIC_MASS = {"H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999,
                "AR": 39.948, "HE": 4.0026, "S": 32.06, "F": 18.998,
                "CL": 35.45, "E": 5.486e-4}


def _chemkin_molar_mass(comp_field: str) -> float:
    """Molar mass (kg/kmol) from the NASA-7 header's elemental-composition
    columns 25-44: four (2-char element, 3-char count) groups."""
    w = 0.0
    for k in range(0, min(len(comp_field), 20), 5):
        el = comp_field[k:k + 2].strip().upper()
        cnt = comp_field[k + 2:k + 5].strip()
        if not el or not cnt:
            continue
        try:
            n = float(cnt)
        except ValueError:
            continue
        if el in _ATOMIC_MASS and n > 0:
            w += _ATOMIC_MASS[el] * n
    if w <= 0.0:
        raise ValueError(f"cannot parse elemental composition "
                         f"{comp_field!r}")
    return w

def read_chemkin(path: str, species: tuple | None = None,
                 nondimensional: bool = True,
                 ispref: int = 1) -> MixtureTable:
    """Parse a NASA-7 CHEMKIN THERMO file (the standard fixed-column
    format: per species one header line with name/T-ranges + three lines
    of 5 coefficients; coefficients are cp/R polynomials). Only the
    low-temperature range is kept, matching the reference's single-range
    use (THERMO_TLIM 'currently not used', thermodynamics.f90:333-337)."""
    names, data = [], []
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    i = 0
    while i < len(lines):
        ln = lines[i]
        up = ln.strip().upper()
        if up.startswith("THERMO") or up.startswith("END") or not ln.strip():
            i += 1
            continue
        if len(ln.rstrip()) >= 70 and ln.rstrip().endswith("1") \
                and not ln.lstrip().startswith(("!", "#")):
            name = ln[:18].split()[0]
            try:
                c = []
                for j, nval in ((1, 5), (2, 5), (3, 4)):
                    row = lines[i + j]
                    for k in range(nval):
                        c.append(float(row[k * 15:(k + 1) * 15]))
                # rows: a1..a7 high range then a1..a7 low range
                low = np.asarray(c[7:14])
                names.append(name)
                data.append((low, _chemkin_molar_mass(ln[24:44])))
                i += 4
                continue
            except (ValueError, IndexError):
                pass
        i += 1
    if species is not None:
        keep = [names.index(s) for s in species]
        names = [names[k] for k in keep]
        data = [data[k] for k in keep]
    if not names:
        raise ValueError(f"no NASA-7 species records found in {path}")
    nsp = len(names)
    ai = np.zeros((7, nsp))
    W = np.empty(nsp)
    for k, (low, wk) in enumerate(data):
        ai[:, k] = low
        W[k] = wk
    # NASA-7 stores cp/R, h/R (a6 in Kelvin), s/R: multiplying every
    # coefficient by the specific gas constant R_i = RGAS/W_i yields the
    # mass-specific convention of h_species/cp_species above
    ai = ai * RGAS / W[None, :]
    R = RGAS / W
    ncp = 5
    rref = R[min(ispref, nsp - 1)]
    cpref = 0.0
    for icp in range(ncp - 1, -1, -1):
        cpref = cpref * TREF + ai[icp, min(ispref, nsp - 1)]
    gama0 = cpref / (cpref - rref)
    if nondimensional:
        R = R / rref
        ai = ai.copy()
        # a6 has enthalpy units (J/kg) after the *R conversion above:
        # h_nd = h / (cpref TREF)
        ai[5] = ai[5] / (cpref * TREF)
        ai[6] = ai[6] / cpref
        for icp in range(ncp):
            ai[icp] = ai[icp] * TREF ** icp / cpref
    return MixtureTable(name="chemkin", species=tuple(names), W=W, R=R,
                        ai=ai, ncp=ncp, tref=TREF, cpref=cpref, rref=rref,
                        gama0=gama0, nondimensional=nondimensional)
