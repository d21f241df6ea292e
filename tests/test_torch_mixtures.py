"""The port's combustion mixtures (tlab_tpu_torch/physics/mixtures.py and
the `mix` branches of dycore/compressible.py, dycore/nscbc.py, the runtime,
the initial state and the Favre statistics) against tlab_tpu's, float64 on
the CPU:

- the caloric tables of every named mixture and of a CHEMKIN file the test
  writes, bit for bit; the species and mixture cp, h and entropy, the gas
  constant, gamma and the enthalpy inversion to 1e-13; and what
  tests/test_mixtures.py holds tlab_tpu to (dh/dT = cp, the formation
  enthalpies, the units);
- the compressible set with a mixture: the caloric Newton, the primitive
  recovery, the right-hand sides (both energies), the CFL, one RK step and
  five with a buffer and with NSCBC outflow, to 1e-10 of each field's max;
- tests/data/case02_small3d.ini with Mixture=unidecomp and a relaxation
  buffer through both command lines (dns.out in every printed digit, the
  avg files to 1e-8 of each column's max), and with NSCBC outflow too,
  where tlab_tpu's characteristic energy leaves out the balance species'
  formation enthalpy and the pressure turns negative at the first step:
  the port stops after the same step (ROADMAP C)."""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import compressible as jcomp
from tlab_tpu.dycore import nscbc as jn
from tlab_tpu.physics import mixtures as jmx
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import averages as javg
from tlab_tpu.tools import cli as jcli
from tlab_tpu.tools.initialize import \
    compressible_initial_state as jcomp_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.dycore import compressible as tcomp
from tlab_tpu_torch.dycore import nscbc as tn
from tlab_tpu_torch.physics import mixtures as tmx
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.tools.initialize import compressible_initial_state

F64 = torch.float64
TOL = 1e-10
GAMMA, MACH = 1.4, 0.3
DATA = os.path.join(os.path.dirname(__file__), "data")
CASE02 = os.path.join(DATA, "case02_small3d.ini")

torch.set_num_threads(2)
threadpool_limits(1, user_api="blas")

# a NASA-7 file of three species in the standard fixed columns
CHEMKIN = """THERMO
   300.000  1000.000  5000.000
O2                TPIS89O   2    0    0    0G   200.000  3500.000  1000.000    1
 3.28253784E+00 1.48308754E-03-7.57966669E-07 2.09470555E-10-2.16717794E-14    2
-1.08845772E+03 5.45323129E+00 3.78245636E+00-2.99673416E-03 9.84730201E-06    3
-9.68129509E-09 3.24372837E-12-1.06394356E+03 3.65767573E+00                   4
N2                121286N   2               G   300.000  5000.000  1000.000    1
 0.02926640E+02 0.14879768E-02-0.05684760E-05 0.10097038E-09-0.06753351E-13    2
-0.09227977E+04 0.05980528E+02 0.03298677E+02 0.14082404E-02-0.03963222E-04    3
 0.05641515E-07-0.02444854E-10-0.10208999E+04 0.03950372E+02                   4
H2O               L 8/89H   2O   1    0    0G   200.000  3500.000  1000.000    1
 3.03399249E+00 2.17691804E-03-1.64072518E-07-9.70419870E-11 1.68200992E-14    2
-3.00042971E+04 4.96677010E+00 4.19864056E+00-2.03643410E-03 6.52040211E-06    3
-5.48797062E-09 1.77197817E-12-3.02937267E+04-8.49032208E-01                   4
END
"""


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b))
    return np.max(np.abs(a - b)) / scale if scale > 0 \
        else np.max(np.abs(a - b))


def _same_table(a, b):
    for field in ("name", "species", "ncp", "tref", "cpref", "rref",
                  "gama0", "nondimensional"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("W", "R", "ai"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("nondimensional", [True, False])
@pytest.mark.parametrize("name", sorted(tmx.MIXTURES))
def test_tables_equal_jax(name, nondimensional):
    _same_table(tmx.build_mixture(name, nondimensional),
                jmx.build_mixture(name, nondimensional))


def test_chemkin_file_reads_as_jax(tmp_path):
    """read_chemkin on a NASA-7 file (all species, a chosen subset and
    order): the low-range coefficients, the molar masses from the
    composition columns, the units."""
    path = tmp_path / "therm.dat"
    path.write_text(CHEMKIN)
    for kw in ({}, {"species": ("H2O", "O2")},
               {"nondimensional": False}):
        a = tmx.read_chemkin(str(path), **kw)
        _same_table(a, jmx.read_chemkin(str(path), **kw))
    assert a.species == ("O2", "N2", "H2O")
    assert abs(a.W[2] - 18.015) < 1e-9
    with pytest.raises(ValueError, match="no NASA-7"):
        empty = tmp_path / "empty.dat"
        empty.write_text("THERMO\nEND\n")
        tmx.read_chemkin(str(empty))


def _rand_Y(nsp, shape, rng):
    Y = rng.random((nsp,) + shape)
    return Y / Y.sum(axis=0)


@pytest.mark.parametrize("name", ["bs", "peters1991", "onestep",
                                  "unidecomp"])
def test_field_functions_match_jax(name):
    t, j = tmx.build_mixture(name), jmx.build_mixture(name)
    rng = np.random.default_rng(1)
    T = rng.uniform(0.9, 6.0, (6, 5))
    Y = _rand_Y(t.nsp, T.shape, rng)
    Tt, Yt = torch.from_numpy(T), torch.from_numpy(Y)
    for fn, args in (("cp_species", (T,)), ("h_species", (T,)),
                     ("entropy_species", (T,)), ("cp_mixture", (T, Y)),
                     ("h_mixture", (T, Y)), ("gamma_mixture", (T, Y))):
        a = getattr(tmx, fn)(t, *(torch.from_numpy(x) for x in args))
        b = getattr(jmx, fn)(j, *(jnp.asarray(x) for x in args))
        assert _rel(a, b) <= 1e-13, fn
    assert _rel(tmx.gas_constant(t, Yt), jmx.gas_constant(j, jnp.asarray(Y))
                ) <= 1e-15
    h = tmx.h_mixture(t, Tt, Yt)
    back = tmx.temperature_from_enthalpy(t, h, Yt, T0=Tt * 0.9)
    assert _rel(back, jmx.temperature_from_enthalpy(
        j, jnp.asarray(h.numpy()), jnp.asarray(Y),
        T0=jnp.asarray(T * 0.9))) <= 1e-13
    assert _rel(back, T) <= 1e-10


# tests/test_mixtures.py on the port's functions

@pytest.mark.parametrize("name", ["bs", "peters1991", "onestep",
                                  "unidecomp"])
def test_enthalpy_is_the_integral_of_cp(name):
    """dh/dT = cp, and h(T_data_ref) is the formation enthalpy."""
    t = tmx.build_mixture(name, nondimensional=False)
    T = torch.linspace(250.0, 2000.0, 8, dtype=F64)
    dT = 1e-3
    dh = (tmx.h_species(t, T + dT) - tmx.h_species(t, T - dT)) / (2 * dT)
    assert torch.allclose(dh, tmx.cp_species(t, T), rtol=1e-7)
    h298 = tmx.h_species(t, torch.tensor([298.0], dtype=F64))[:, 0]
    href = np.array([tmx._COMBUSTION_SPECIES[s][1]
                     / tmx._COMBUSTION_SPECIES[s][0] for s in t.species])
    assert np.allclose(h298.numpy(), href, rtol=1e-10, atol=1e-8)


def test_units_change_nothing_physical():
    """Nondimensional h and cp are the dimensional ones over cpref TREF and
    cpref."""
    td = tmx.build_mixture("bs", nondimensional=False)
    tn_ = tmx.build_mixture("bs", nondimensional=True)
    rng = np.random.default_rng(0)
    T = torch.from_numpy(rng.uniform(260.0, 1800.0, (4, 3)))
    Y = torch.from_numpy(_rand_Y(td.nsp, (4, 3), rng))
    hd = tmx.h_mixture(td, T, Y)
    hn = tmx.h_mixture(tn_, T / td.tref, Y)
    assert torch.allclose(hn * tn_.cpref * tn_.tref, hd, rtol=1e-12)
    assert torch.allclose(tmx.cp_mixture(tn_, T / td.tref, Y) * tn_.cpref,
                          tmx.cp_mixture(td, T, Y), rtol=1e-12)


# the compressible set with a mixture

def _case(text_edits=(), shape=(32, 48, 8)):
    """case02_small3d.ini at `shape` with Mixture=unidecomp and the edits."""
    with open(CASE02) as fh:
        text = fh.read()
    nx, ny, nz = shape
    for old, new in (("Imax=128", f"Imax={nx}"), ("Jmax=64", f"Jmax={ny}"),
                     ("Kmax=16", f"Kmax={nz}"),
                     ("points_1=129", f"points_1={nx + 1}"),
                     ("points_1=64", f"points_1={ny}"),
                     ("points_1=17", f"points_1={nz + 1}"),
                     ("[Flow]", "[Thermodynamics]\nMixture=unidecomp\n"
                                "[Flow]"), *text_edits):
        assert old in text, old
        text = text.replace(old, new, 1)
    return text


BUFFER = ("[BufferZone]\nType=none",
          "[BufferZone]\nType=relaxation\nPointsJmin=8\nPointsJmax=8\n"
          "Parameters=1.0,2.0")
OUTFLOW = (("VelocityJmin=freeslip", "VelocityJmin=outflow"),
           ("VelocityJmax=freeslip", "VelocityJmax=outflow"))


def _sims(text):
    return (JSimulation.from_case(jload_case(JIni(text=text))),
            Simulation.from_case(load_case(Ini(text=text)), dtype=F64,
                                 device="cpu"))


def _state(jsim, energy, seed=2):
    """A random state with the unidecomp mass fraction in [0, 1], in both
    packages (the port's from tlab_tpu's arrays)."""
    rng = np.random.default_rng(seed)
    shape = jsim.grid.shape
    prim = (1.0 + 0.05 * rng.standard_normal(shape),
            *(0.2 * rng.standard_normal(shape) for _ in range(3)),
            1.0 + 0.05 * rng.standard_normal(shape))
    s = rng.random((1,) + tuple(shape))
    Uj = jcomp.from_primitive(*(jnp.asarray(a) for a in prim), GAMMA, MACH,
                              s=jnp.asarray(s), mix=jsim.comp["mixture"],
                              energy=energy)
    return Uj, tcomp.CompState(*(torch.from_numpy(np.array(a))
                                 for a in Uj)), prim, s


def _close(a, b, tol=TOL):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert _rel(x, y) <= tol


@pytest.mark.parametrize("energy", ["total", "internal"])
def test_primitives_and_rhs_match_jax(energy):
    """from_primitive, the caloric Newton (mixture_thermal), the primitive
    recovery, the right-hand side (the stress divergence and the mixture's
    conduction), the acoustic CFL with gamma0."""
    jsim, tsim = _sims(_case())
    mj, mt = jsim.comp["mixture"], tsim.comp["mixture"]
    Uj, Ut, prim, s = _state(jsim, energy)
    _close(tcomp.from_primitive(*(torch.from_numpy(a) for a in prim),
                                GAMMA, MACH, s=torch.from_numpy(s), mix=mt,
                                energy=energy), Uj, 1e-15)
    prim_fn = {"total": "primitive", "internal": "primitive_internal"}
    _close(getattr(tcomp, prim_fn[energy])(tsim.P, Ut, GAMMA, MACH, mix=mt),
           getattr(jcomp, prim_fn[energy])(jsim.P, Uj, GAMMA, MACH, mix=mj),
           1e-13)
    if energy == "total":
        hj = jcomp.rhs_compressible(jsim.P, Uj, GAMMA, MACH, 1e-3, 0.7,
                                    mix=mj, form="skewsymmetric")
        ht = tcomp.rhs_compressible(tsim.P, Ut, GAMMA, MACH, 1e-3, 0.7,
                                    mix=mt, form="skewsymmetric")
    else:
        hj = jcomp.rhs_compressible_internal(jsim.P, Uj, GAMMA, MACH, 1e-3,
                                             0.7, mix=mj)
        ht = tcomp.rhs_compressible_internal(tsim.P, Ut, GAMMA, MACH, 1e-3,
                                             0.7, mix=mt)
    _close(ht, hj, 1e-12)
    cj = float(jcomp.acoustic_cfl_max(jsim.P, Uj, GAMMA, MACH, mix=mj,
                                      energy=energy))
    assert abs(float(tcomp.acoustic_cfl_max(tsim.P, Ut, GAMMA, MACH, mix=mt,
                                            energy=energy)) - cj) \
        <= 1e-13 * cj


def test_scalar_count_is_checked_as_jax():
    jsim, tsim = _sims(_case())
    Uj, Ut, _, _ = _state(jsim, "internal")
    Ut = Ut._replace(rhos=torch.cat([Ut.rhos, Ut.rhos]))
    with pytest.raises(ValueError, match="expects 1 transported"):
        tcomp.primitive(tsim.P, Ut, GAMMA, MACH, mix=tsim.comp["mixture"])


@pytest.mark.parametrize("edits", [(BUFFER,), (BUFFER, *OUTFLOW)],
                         ids=["buffer", "buffer_outflow"])
def test_rk_steps_match_jax(edits):
    """One RK4 step and five of case02 with the mixture and the buffer
    (references from the same state), walls or NSCBC outflow, at a dt the
    outflow case survives five steps of."""
    jsim, tsim = _sims(_case(edits))
    Uj = jcomp_state(jsim, seed=4)
    Ut = tcomp.CompState(*(torch.from_numpy(np.array(a)) for a in Uj))
    jsim.attach_buffer_compressible(Uj)
    tsim.attach_buffer_compressible(Ut)
    jc, tc = jsim.comp, tsim.comp
    assert (tc["nscbc"] is None) == (len(edits) == 1)

    def kw(c):
        return dict(nscbc=c["nscbc"], ly=c["ly"], lx=c["lx"], gas=c["gas"],
                    form=c["form"], energy=c["energy"], mix=c["mixture"],
                    gvec=c["gvec"], buffer=c["buffer"])
    step = jax.jit(lambda U: jcomp.rk_step_compressible(
        jsim.P, U, 2e-4, jc["gamma"], jc["mach"], jsim.nsp.visc,
        jc["prandtl"], **kw(jc)))
    for n in range(1, 6):
        Uj = step(Uj)
        Ut = tcomp.rk_step_compressible(
            tsim.P, Ut, 2e-4, tc["gamma"], tc["mach"], tsim.nsp.visc,
            tc["prandtl"], **kw(tc))
        if n in (1, 5):
            _close(Ut, Uj)


def test_nscbc_with_a_mixture_matches_jax():
    """apply_nscbc with the mixture: the local gamma field and the
    scalar characteristics' formation-enthalpy coupling, in total
    energy."""
    jsim, tsim = _sims(_case(OUTFLOW))
    Uj, Ut, _, _ = _state(jsim, "total")
    mj, mt = jsim.comp["mixture"], tsim.comp["mixture"]
    hj = jcomp.rhs_compressible(jsim.P, Uj, GAMMA, MACH, 1e-3, 0.7, mix=mj)
    ht = tcomp.CompState(*(torch.from_numpy(np.array(a)) for a in hj))
    _close(tn.apply_nscbc(tsim.P, Ut, ht, GAMMA, MACH, tsim.comp["nscbc"],
                          1.0, mix=mt),
           jn.apply_nscbc(jsim.P, Uj, hj, GAMMA, MACH, jsim.comp["nscbc"],
                          1.0, mix=mj), 1e-13)


def test_initial_state_matches_jax():
    """The mixture's temperature from p = rho R(Y) T / (gama0 M^2) and
    its energy with the formation enthalpies."""
    jsim, tsim = _sims(_case())
    _close(compressible_initial_state(tsim, seed=5),
           jcomp_state(jsim, seed=5), 1e-11)


def _cli_runs(top, text):
    outs = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        out = top / name
        out.mkdir()
        (out / "tlab.ini").write_text(text)
        common = ["--ini", str(out / "tlab.ini"), "--outdir", str(out),
                  "--x64", *extra]
        for command in ("ini", "dns"):
            assert main([command, *common]) == 0
        outs[name] = out
    return outs


def test_case02_with_a_mixture_through_both_clis(tmp_path):
    """5 steps with the buffer between free-slip walls: dns.out in every
    printed digit, the avg files' columns (the mixture's e, h, entropy and
    gamma) to 1e-8 of their max."""
    text = _case((BUFFER, ("End=10", "End=5"), ("Restart=10", "Restart=5")),
                 shape=(32, 32, 8))
    outs = _cli_runs(tmp_path, text)
    t, j = outs["torch"], outs["jax"]
    assert (t / "dns.out").read_text() == (j / "dns.out").read_text()
    for name in ("avg5", "avg5s1"):
        _, gj, cj = javg.read_avg(str(j / name))
        _, gt, ct = tavg.read_avg(str(t / name))
        assert gt == gj and list(ct) == list(cj)
        for n in cj:
            assert np.max(np.abs(cj[n] - ct[n])) <= max(
                1e-8 * np.max(np.abs(cj[n])), 1e-13), (name, n)


def test_outflow_with_a_mixture_stops_as_jax(tmp_path):
    """With NSCBC outflow too, tlab_tpu's run turns p negative at the first
    step (its characteristic energy leaves out the balance species'
    formation enthalpy times the density correction, ROADMAP C): the
    port's dns.out agrees on the start's row digit for digit and stops
    after the same step, its pressure negative.  (What a blown-up step
    prints is round-off amplified: the rows after the start differ.)"""
    text = _case((BUFFER, *OUTFLOW, ("End=10", "End=3"),
                  ("Restart=10", "Restart=0")), shape=(32, 32, 8))
    outs = _cli_runs(tmp_path, text)
    rows = {}
    for name, out in outs.items():
        rows[name] = [r.split() for r in (out / "dns.out").read_text()
                      .splitlines() if not r.startswith("#")]
    assert rows["torch"][0] == rows["jax"][0]
    for name, got in rows.items():
        assert len(got) == 2 and got[1][0] != "0" and got[1][1] == "1", name
        assert float(got[1][7]) < 0.0, name
