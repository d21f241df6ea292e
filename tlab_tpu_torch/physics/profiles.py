"""Analytic mean-profile families for initial/background conditions.

Equivalent of the reference's Profiles module (src/utils/profiles.f90:169-254):
f(y) = mean + delta*amplify(xi) + slope terms,  xi = (y - ymean)/thick.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Profile:
    type: str = "none"           # the reference's 20 parseable families
    mean: float = 0.0
    delta: float = 0.0
    thick: float = 1.0
    ymean: float = 0.0           # absolute reference height
    lslope: float = 0.0
    uslope: float = 0.0
    diam: float = 0.0
    surface_thick: float = 1.0   # parameters(3): erfsurface / gaussiantanhsym
    surface_delta: float = 0.0   # parameters(4): erfsurface amplitude

    def __call__(self, y: np.ndarray) -> np.ndarray:
        yrel = y - self.ymean
        if self.type == "none":
            amplify = np.zeros_like(yrel)
        elif self.thick == 0.0:
            amplify = 0.5 * np.sign(yrel)
        else:
            xi = yrel / self.thick
            if self.type == "tanh":
                amplify = 0.5 * np.tanh(-0.5 * xi)
            elif self.type == "tanhsymmetric":
                amplify = 0.5 * (np.tanh(-0.5 * (xi - 0.5 * self.diam / self.thick))
                                 + np.tanh(0.5 * (xi + 0.5 * self.diam / self.thick))
                                 - 1.0)
            elif self.type == "tanhantisymmetric":
                amplify = 0.25 * (np.tanh(-0.5 * (xi - 0.5 * self.diam / self.thick))
                                  - np.tanh(-0.5 * (xi + 0.5 * self.diam / self.thick)))
            elif self.type in ("erf", "erfantisym", "erfsurface"):
                from scipy.special import erf
                amplify = 0.5 * erf(-0.5 * xi)
            elif self.type == "linear":
                amplify = -xi
            elif self.type == "bickley":
                amplify = 1.0 / np.cosh(0.5 * xi) ** 2
            elif self.type == "gaussian":
                amplify = np.exp(-0.5 * xi ** 2)
            elif self.type == "gaussiansurface":
                # surface-peaked gaussian shell used by the IC generator
                amplify = np.exp(-0.5 * xi ** 2)
            elif self.type == "gaussiansinuous":     # symmetric pair
                amplify = (np.exp(-0.5 * (xi - 0.5 * self.diam / self.thick) ** 2)
                           + np.exp(-0.5 * (xi + 0.5 * self.diam / self.thick) ** 2))
            elif self.type == "gaussianvaricose":    # antisymmetric pair
                amplify = (np.exp(-0.5 * (xi - 0.5 * self.diam / self.thick) ** 2)
                           - np.exp(-0.5 * (xi + 0.5 * self.diam / self.thick) ** 2))
            elif self.type == "parabolicsurface":
                amplify = ((1.0 + 0.5 * xi) * (1.0 - 0.5 * xi))
            elif self.type == "linearcrop":
                amplify = np.where(yrel < 0.0,
                                   np.minimum(self.lslope * yrel,
                                              self.lslope * self.thick),
                                   np.maximum(self.uslope * yrel,
                                              self.uslope * self.thick)) \
                    / max(self.delta, 1e-30)
            elif self.type == "mixedlayer":
                base = np.where(yrel < 0.0,
                                np.minimum(self.lslope * yrel,
                                           self.lslope * self.thick),
                                np.maximum(self.uslope * yrel,
                                           self.uslope * self.thick))
                base = base - 0.25 * self.uslope * self.thick * \
                    (1.0 - np.sign(y - self.thick))
                amplify = base / max(self.delta, 1e-30)
            elif self.type == "parabolic":
                amplify = (1.0 + 0.5 * xi) * (1.0 - 0.5 * xi)
            elif self.type == "ekmanu":
                amplify = 1.0 - np.exp(-xi) * np.cos(xi)
            elif self.type == "ekmanp":
                # EKMAN_U_P: Ekman profile + analytic perturbation
                # (profiles.f90:230-236)
                amplify = 1.0 - np.exp(-xi) * np.cos(xi)
                cn = np.pi * np.pi / 16.0
                zamp = (np.sqrt(2.0) * xi * np.exp(-xi * xi / (8.0 * cn))
                        / (self.thick * self.thick * 4.0 * cn) ** 1.5)
                amplify = amplify + zamp
            elif self.type == "ekmanv":
                amplify = -np.exp(-xi) * np.sin(xi)
            elif self.type == "gaussiantanhsymmetric":
                amplify = np.exp(-0.5 * xi ** 2)
            else:
                raise ValueError(f"unknown profile type {self.type!r}")
        f = (self.mean + self.delta * amplify
             + self.lslope * yrel * 0.5 * (1.0 - np.sign(yrel))
             + self.uslope * yrel * 0.5 * (1.0 + np.sign(yrel)))
        # special post-terms (profiles.f90:268-277)
        if self.type == "erfsurface":
            from scipy.special import erf
            xis = y / max(self.surface_thick, 1e-30)
            f = f + self.surface_delta * 0.5 * (1.0 + erf(-0.5 * xis))
        elif self.type == "gaussiantanhsymmetric":
            st = max(self.surface_thick, 1e-30)
            fac = (np.tanh(-0.5 * (yrel - 0.5 * self.diam) / st)
                   + np.tanh(0.5 * (yrel + 0.5 * self.diam) / st) - 1.0)
            f = f * fac
        return f


def der_to_thick(profile_type: str, delta: float, derivative: float,
                 uslope: float = 0.0) -> float:
    """[...]Derivative<tag> alternative input (Profiles_DerToThick,
    profiles.f90:283-308)."""
    if profile_type.startswith("tanh"):
        return -delta / derivative / 4.0
    if profile_type in ("erf", "erfantisym"):
        return -delta / (derivative - uslope) / (2.0 * np.sqrt(np.pi))
    raise ValueError(f"Derivative input undeveloped for {profile_type!r}")


def der_to_delta(profile_type: str, thick: float, derivative: float,
                 uslope: float = 0.0) -> float:
    """Profiles_DerToDelta (profiles.f90:312-330)."""
    if profile_type.startswith("tanh"):
        return -thick * derivative * 4.0
    if profile_type in ("erf", "erfantisym"):
        return -thick * (derivative - uslope) * (2.0 * np.sqrt(np.pi))
    raise ValueError(f"Derivative input undeveloped for {profile_type!r}")
