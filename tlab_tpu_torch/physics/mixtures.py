"""Names of the combustion mixtures (tlab_tpu/physics/mixtures.py:65).

config.consistency_check needs only the table's keys; the species are kept
so the table reads as the original.  The thermodynamics are not ported.
"""
from __future__ import annotations

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
