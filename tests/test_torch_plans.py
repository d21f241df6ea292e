"""The port's own copies of the NumPy modules (constants, grid, fdm with
its filters and staggered operators, physics.params, config, the plan-time
part of ops/elliptic.py) and of the host NumPy parts of the physics modules
(the thermodynamic constants, the radiation's band tables and integration
matrices, the wavemaker's tables, the source props) give exactly what
tlab_tpu's originals give: the copies differ from them only in their import
lines, so every comparison is exact (np.array_equal, ==), with no
tolerance."""
import dataclasses
import enum
import pathlib

import numpy as np
import pytest

from tlab_tpu import config as jconfig
from tlab_tpu import constants as jconst
from tlab_tpu import grid as jgrid
from tlab_tpu.fdm import filters as jfilters
from tlab_tpu.fdm import plan as jplan
from tlab_tpu.fdm import stagger as jstagger
from tlab_tpu.ops import elliptic as jelliptic
from tlab_tpu.physics import chemistry as jchem
from tlab_tpu.physics import forcing as jforcing
from tlab_tpu.physics import microphysics as jmic
from tlab_tpu.physics import params as jparams
from tlab_tpu.physics import radiation as jrad
from tlab_tpu.physics import thermo as jthermo
from tlab_tpu_torch import config as tconfig
from tlab_tpu_torch import constants as tconst
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.fdm import filters as tfilters
from tlab_tpu_torch.fdm import plan as tplan
from tlab_tpu_torch.fdm import stagger as tstagger
from tlab_tpu_torch.ops import elliptic as telliptic
from tlab_tpu_torch.physics import chemistry as tchem
from tlab_tpu_torch.physics import forcing as tforcing
from tlab_tpu_torch.physics import microphysics as tmic
from tlab_tpu_torch.physics import params as tparams
from tlab_tpu_torch.physics import radiation as trad
from tlab_tpu_torch.physics import thermo as tthermo

DATA = pathlib.Path(__file__).resolve().parent / "data"
CASES = sorted(p.name for p in DATA.glob("*.ini"))

# a stretched wall-normal axis: a uniform segment, then a tanh-stretched one
SEGMENTS = [{"n": 17, "end": 0.5, "opts": "uniform", "vals": ()},
            {"n": 16, "end": 1.0, "opts": "tanh", "vals": (0.5, 0.1, 0.75)}]


def _same(a, b, where="value"):
    """Assert that `a` (port) and `b` (tlab_tpu) hold the same data; objects
    of the two packages' twin classes compare by class name and fields."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], where
        for name in fa:
            _same(getattr(a, name), getattr(b, name), f"{where}.{name}")
    elif isinstance(a, tconfig.Ini):
        assert isinstance(b, jconfig.Ini), where
        assert a.data == b.data, where
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict), where
        assert [_key(k) for k in a] == [_key(k) for k in b], where
        for (ka, va), vb in zip(a.items(), b.values()):
            _same(va, vb, f"{where}[{ka!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (va, vb) in enumerate(zip(a, b)):
            _same(va, vb, f"{where}[{i}]")
    elif isinstance(a, enum.Enum):
        assert _key(a) == _key(b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _key(k):
    return (type(k).__name__, k.name) if isinstance(k, enum.Enum) else k


def _grids(kind):
    if kind == "uniform":
        args = (24, 17, 12, 2.0 * np.pi, 1.0, np.pi)
        return tgrid.uniform_grid(*args), jgrid.uniform_grid(*args)
    out = []
    for mod in (tgrid, jgrid):
        y = mod.build_axis_from_segments(SEGMENTS, False)
        assert not y.uniform
        out.append(mod.Grid(
            mod.make_axis(np.arange(16) * (2.0 * np.pi / 16), True), y,
            mod.make_axis(np.arange(8) * (np.pi / 8), True)))
    return out


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_grid_matches(kind):
    gt, gj = _grids(kind)
    assert gt.shape == gj.shape
    _same(gt, gj, "grid")


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_deriv_plan_matches(kind, axis):
    """Every array of DerivPlan, every boundary-condition variant."""
    gt, gj = _grids(kind)
    pt = getattr(tplan.build_fdm_plan(gt), axis)
    pj = getattr(jplan.build_fdm_plan(gj), axis)
    assert len(pt.d12) == len(pj.d12) >= 1
    _same(pt, pj, f"fdm.{axis}")


def test_constants_match():
    for name in ("BC", "Scheme", "EquationSet"):
        et, ej = getattr(tconst, name), getattr(jconst, name)
        assert [(m.name, m.value) for m in et] == \
            [(m.name, m.value) for m in ej]
    assert (tconst.AXIS_X, tconst.AXIS_Y, tconst.AXIS_Z) == \
        (jconst.AXIS_X, jconst.AXIS_Y, jconst.AXIS_Z)


@pytest.mark.parametrize("kwargs", [
    {}, {"reynolds": 5000.0, "schmidt": (1.0, 0.7)},
    {"reynolds": 300.0, "schmidt": (), "prandtl": 0.7, "froude": 2.0,
     "rossby": 3.0}])
def test_nsparams_match(kwargs):
    pt, pj = tparams.NSParams(**kwargs), jparams.NSParams(**kwargs)
    _same(pt, pj, "nsp")
    assert pt.visc == pj.visc and pt.n_scalars == pj.n_scalars
    for i in range(pt.n_scalars):
        assert pt.diffusivity(i) == pj.diffusivity(i)


@pytest.mark.parametrize("name", CASES)
def test_load_case_matches(name):
    """Every case file of tests/data parses to the same CaseSetup, field by
    field, the option dataclasses (buoyancy, Coriolis, buffer, filters)
    included, and passes the same consistency check."""
    ct = tconfig.load_case(str(DATA / name))
    cj = jconfig.load_case(str(DATA / name))
    _same(ct, cj, "case")
    tconfig.consistency_check(ct)
    jconfig.consistency_check(cj)
    yw = np.linspace(0.0, 1.0, 7)
    for pt, pj in zip(ct.vel_profiles + ct.scal_profiles,
                      cj.vel_profiles + cj.scal_profiles):
        assert np.array_equal(pt(yw), pj(yw))


def test_case_list_is_not_empty():
    assert len(CASES) >= 7


# ---------------------------------------------------------------------------
# fdm/filters.py, fdm/stagger.py and the NumPy part of ops/elliptic.py
# ---------------------------------------------------------------------------

def _axis_nodes(kind):
    gt, _ = _grids(kind)
    return gt.x.nodes, gt.y.nodes


@pytest.mark.parametrize("call", [
    lambda m, x, y: m.compact4_matrix(x, 0.49, True),
    lambda m, x, y: m.compact4_matrix(y, 0.45, False),
    lambda m, x, y: m.compact4_matrix(y, 0.3, False, bcs=("zero", "biased")),
    lambda m, x, y: m.explicit6_matrix(x.size, True),
    lambda m, x, y: m.explicit6_matrix(y.size, False),
    lambda m, x, y: m.explicit4_matrix(x, True),
    lambda m, x, y: m.explicit4_matrix(y, False),
    lambda m, x, y: m.tophat_matrix(x, 2, True),
    lambda m, x, y: m.tophat_matrix(y, 4, False),
    lambda m, x, y: m.spectral_matrix(x.size, "band", (0.0, 0.6)),
    lambda m, x, y: m.spectral_matrix(x.size, "erf", (0.5, 0.1)),
], ids=["compact4_periodic", "compact4_walls", "compact4_zero_wall",
        "explicit6_periodic", "explicit6_walls", "explicit4_periodic",
        "explicit4_walls", "tophat_periodic", "tophat_walls",
        "spectral_band", "spectral_erf"])
@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_filter_matrices_match(kind, call):
    x, y = _axis_nodes(kind)
    _same(call(tfilters, x, y), call(jfilters, x, y), "filter")


def test_filters_module_has_the_same_functions():
    names = [n for n in vars(jfilters) if not n.startswith("__")]
    assert sorted(n for n in vars(tfilters) if not n.startswith("__")) == \
        sorted(names)
    names = [n for n in vars(jstagger) if not n.startswith("__")]
    assert sorted(n for n in vars(tstagger) if not n.startswith("__")) == \
        sorted(names)


@pytest.mark.parametrize("n, length", [(16, 2.0 * np.pi), (17, 1.0),
                                       (64, 3.0)])
def test_stagger_ops_match(n, length):
    ot = tstagger.build_stagger_ops(n, length / n)
    oj = jstagger.build_stagger_ops(n, length / n)
    _same(ot, oj, "stagger")
    assert sorted(ot) == ["dpv", "dvp", "ipv", "ivp"]
    _same(tstagger.modified_wavenumber(n, length),
          jstagger.modified_wavenumber(n, length), "mwn")


@pytest.mark.parametrize("ibc", ["NN", "DD", "ND", "DN"])
@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_elliptic_plan_matches(kind, ibc):
    """build_pencil and build_elliptic_plan (with _reflection_basis and
    _pencil_eig behind it): every array of the plan, exactly."""
    gt, gj = _grids(kind)
    ft, fj = tplan.build_fdm_plan(gt), jplan.build_fdm_plan(gj)
    bt, bj = tconst.BC[ibc], jconst.BC[ibc]
    _same(telliptic.build_pencil(ft.y, bt), jelliptic.build_pencil(fj.y, bj),
          "pencil")
    _same(telliptic.build_elliptic_plan(ft, ibc=bt),
          jelliptic.build_elliptic_plan(fj, ibc=bj), "plan")


def test_elliptic_plan_overrides_and_dense_solve_match():
    gt, gj = _grids("uniform")
    ft, fj = tplan.build_fdm_plan(gt), jplan.build_fdm_plan(gj)
    lam_x, lam_z = -np.arange(13.0) ** 2, -np.arange(12.0)
    pt = telliptic.build_elliptic_plan(ft, shift=0.5, lam_x=lam_x,
                                       lam_z=lam_z)
    pj = jelliptic.build_elliptic_plan(fj, shift=0.5, lam_x=lam_x,
                                       lam_z=lam_z)
    _same(pt, pj, "plan")
    rng = np.random.default_rng(0)
    f_hat = rng.standard_normal((13, 17, 12)) \
        + 1j * rng.standard_normal((13, 17, 12))
    for alpha in (0.0, -3.0):
        _same(telliptic.solve_modal_dense(pt, f_hat, alpha),
              jelliptic.solve_modal_dense(pj, f_hat, alpha), "dense")
    for at_max in (False, True):
        _same(telliptic.neumann_row_coefs(gt.y.nodes, at_max),
              jelliptic.neumann_row_coefs(gj.y.nodes, at_max), "row")
    _same(telliptic._reflection_basis(7), jelliptic._reflection_basis(7),
          "basis")


# ---------------------------------------------------------------------------
# the host NumPy parts of physics/{thermo,radiation,forcing,...}.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T_ref, p_ref", [(298.0, 1.0e5), (1.0, 1.0),
                                          (290.0, 9.4e4)])
def test_psat_coeffs_match(T_ref, p_ref):
    _same(tthermo.psat_coeffs(T_ref, p_ref), jthermo.psat_coeffs(T_ref,
                                                                 p_ref),
          "psat")
    _same(tthermo.FLATAU, jthermo.FLATAU, "flatau")


@pytest.mark.parametrize("kwargs", [
    {}, {"mixture": "airvapor", "scale_height_inv": 0.05},
    {"nondimensional": False, "scale_height_inv": 9.81},
    {"T_ref": 290.0, "p_ref": 9.4e4, "dsmooth": 0.1},
    {"thermo_param": (-11.1, 0.0056)}])
def test_thermo_params_match(kwargs):
    pt, pj = tthermo.ThermoParams(**kwargs), jthermo.ThermoParams(**kwargs)
    _same(pt, pj, "tp")
    for name, prop in vars(jthermo.ThermoParams).items():
        if isinstance(prop, property):
            _same(getattr(pt, name), getattr(pj, name), name)


@pytest.mark.parametrize("bcs, comps, beta", [
    ((0.3, 0.2, 0.9), [(1.0, 2.0), (0.1, 0.2), (0.01, 0.02)],
     [(0.6,), (1e-3,), (1e-6,)]),
    ((1.0, 1.0, 1.0), [], [(), (), ()]),
    ((0.2, 1.0), [(5.0,), (0.1,), (0.01,)], [(), (), ()]),
    ((), [(3.0,)], [(), (), ()]),
    ((0.5, 0.4, 0.3, 0.8), [(1.0, 2.0)], [(0.3, 0.2), (), ()])])
def test_band_tables_match(bcs, comps, beta):
    _same(trad.derive_band_tables(bcs, comps, beta),
          jrad.derive_band_tables(bcs, comps, beta), "bands")


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_radiation_integrals_match(kind):
    gt, gj = _grids(kind)
    _same(trad.cumulative_matrices(gt.y.nodes),
          jrad.cumulative_matrices(gj.y.nodes), "trapezoid")
    _same(trad.int1_cumulative_matrices(tplan.build_fdm_plan(gt).y),
          jrad.int1_cumulative_matrices(jplan.build_fdm_plan(gj).y), "int1")
    assert trad.MU_REFERENCE == jrad.MU_REFERENCE
    assert trad.SIGMA == jrad.SIGMA
    assert (trad.BETA_DEFAULT_BAND1, trad.BETA_DEFAULT_BAND2) == \
        (jrad.BETA_DEFAULT_BAND1, jrad.BETA_DEFAULT_BAND2)


@pytest.mark.parametrize("text", [
    "[SpecialForcing]\nType=wavemaker\nParameters=0.5\n"
    "Wave1=0.05, 4.0, 30.0, 2.0\nWave2=0.02, 2.0, -60.0, 1.0\n"
    "Envelope=1.0, 0.5, 0.5, -0.3\n",
    "[SpecialForcing]\nType=WaveMaker\nWave1=1, 1, 0, 1\n",
    "[SpecialForcing]\nType=wavemaker\n", ""])
@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_wavemaker_tables_match(text, kind):
    pt = tforcing.wavemaker_from_ini(tconfig.Ini(text=text))
    pj = jforcing.wavemaker_from_ini(jconfig.Ini(text=text))
    if pj is None:
        assert pt is None
        return
    _same(pt, pj, "wavemaker")
    gt, gj = _grids(kind)
    if pj.kx:
        _same(tforcing.wavemaker_fields(pt, gt),
              jforcing.wavemaker_fields(pj, gj), "fields")


def test_source_props_match():
    _same(trad.RadiationProps(type="gray", kappa=2.0, nbands=2),
          jrad.RadiationProps(type="gray", kappa=2.0, nbands=2), "rad")
    _same(tmic.MicrophysicsProps("airwater", (0.1,), 0.5),
          jmic.MicrophysicsProps("airwater", (0.1,), 0.5), "mic")
    _same(tchem.ChemistryProps("ozone", (1.0,), (0.5,), 1, (0.2,)),
          jchem.ChemistryProps("ozone", (1.0,), (0.5,), 1, (0.2,)), "chem")
    _same(tforcing.WavemakerProps(), jforcing.WavemakerProps(), "wm")


# the boundary machinery's copies: the functions (and SpatialStats' host
# methods) whose source is tlab_tpu's, word for word
BOUNDARY_COPIES = [
    ("ibm", n) for n in ("geometry_xbars", "geometry_box", "geometry_hill",
                         "geometry_valley", "build_spline_fill")] + [
    ("dycore.buffer", n) for n in ("BufferSpec", "tau_profile",
                                   "tau_profile_x")] + [
    ("dycore.inflow", "_catmull_rom_weights"),
    ("tools.dns", "_stations"),
    ("stats.spatial", "write_station_budgets"),
    ("stats.spatial", "state_fields")] + [
    ("stats.spatial", f"SpatialStats.{n}") for n in (
        "create", "mean", "covariance", "skewness", "variance",
        "station_table", "reduce_station_table", "_raw_pair",
        "_triple_fluct", "station_budgets")]


@pytest.mark.parametrize("module, name", BOUNDARY_COPIES)
def test_boundary_copies_are_the_originals(module, name):
    import importlib
    import inspect

    def get(pkg):
        obj = importlib.import_module(f"{pkg}.{module}")
        for part in name.split("."):
            obj = getattr(obj, part)
        return inspect.getsource(obj)

    assert get("tlab_tpu_torch") == get("tlab_tpu")


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_boundary_copies_give_the_same_numbers(kind):
    """The copies above on a grid of each kind: the geometries, the fill
    tables of every direction, the relaxation profiles."""
    from tlab_tpu import ibm as jibm
    from tlab_tpu.dycore import buffer as jbuf
    from tlab_tpu_torch import ibm as tibm
    from tlab_tpu_torch.dycore import buffer as tbuf
    gt, gj = _grids(kind)

    def build(mod, g):
        eps = np.maximum(mod.geometry_xbars(g, 2, 3, 2, mirrored=True),
                         mod.geometry_hill(g, 0.2, 0.3, 1.0))
        out = [eps, mod.geometry_valley(g, 3, 1),
               mod.geometry_box(g, 1, 4, 2, 5, 0, 3)]
        for axis, ax in enumerate((g.x, g.y, g.z)):
            out += list(mod.build_spline_fill(
                eps, axis, ax.nodes, ax.periodic, ax.scale, (0.3, 0.1)))
        return out

    _same(build(tibm, gt), build(jibm, gj), "ibm")
    spec = dict(type="both", points_jmin=5, points_jmax=4, points_imin=6,
                points_imax=3, strength=2.0, sigma=3.0)
    _same(tbuf.tau_profile(gt.y.nodes, tbuf.BufferSpec(**spec)),
          jbuf.tau_profile(gj.y.nodes, jbuf.BufferSpec(**spec)), "tau")
    _same(tbuf.tau_profile_x(gt.x.nodes, tbuf.BufferSpec(**spec)),
          jbuf.tau_profile_x(gj.x.nodes, jbuf.BufferSpec(**spec)), "tau_x")


@pytest.mark.parametrize("kind", ["uniform", "stretched", "walls"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_long_line_plans_match(kind, dtype):
    """ops/thomas.py's host plans (the partitioned and the banded one) are
    tlab_tpu's ops/pallas_thomas.py's, array for array: the periodic x axes
    of both grids (8-point segments: 128 divides neither length) and a
    stretched 64-point line between walls."""
    import jax.numpy as jnp
    from tlab_tpu.ops import pallas_thomas as jthomas
    from tlab_tpu_torch.ops import thomas
    if kind == "walls":
        nodes = np.linspace(0.0, 1.0, 64) ** 1.2
        axes = (tgrid.make_axis(nodes, False), jgrid.make_axis(nodes, False))
    else:
        axes = tuple(g.x for g in _grids(kind))
    pt, pj = (mod.build_deriv_plan(ax) for mod, ax in zip((tplan, jplan),
                                                          axes))
    periodic = kind != "walls"
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    _same(thomas.banded_plan(pt.A1, pt.B1, dtype, periodic=periodic),
          jthomas.banded_plan(pj.A1, pj.B1, jdt, periodic=periodic), "d1")
    _same(thomas.partitioned_plan(pt.A2, 128, dtype, periodic),
          jthomas.partitioned_plan(pj.A2, 128, jdt, periodic), "A2")


def test_eos_copy_matches():
    """physics/eos.py is tlab_tpu's: the gas parameters field for field
    and the rational laws on floats to the bit (tests/test_torch_
    compressible.py holds the transport laws on tensors)."""
    from tlab_tpu.physics import eos as jeos
    from tlab_tpu_torch.physics import eos as teos
    gt = teos.GasParams(gamma=1.3, mach=0.4, transport="powerlaw")
    gj = jeos.GasParams(gamma=1.3, mach=0.4, transport="powerlaw")
    _same(gt, gj, "gas")
    _same(teos.GasParams(), jeos.GasParams(), "default gas")
    for name in ("temperature_from_e", "energy_from_t", "sound_speed2"):
        assert getattr(teos, name)(gt, 1.7) == getattr(jeos, name)(gj, 1.7)
    for name in ("pressure", "density", "temperature_from_rho_p"):
        assert getattr(teos, name)(gt, 0.9, 1.7) == \
            getattr(jeos, name)(gj, 0.9, 1.7)


# ROADMAP A13b: the MA_* register set and the combustion mixtures' tables

SREG_FUNCTIONS = ("_pairs", "_reg", "_build_register_table", "build_base",
                  "accumulate", "as_table")


@pytest.mark.parametrize("name", SREG_FUNCTIONS)
def test_spatial_registers_copy_is_the_original(name):
    """stats/spatial_registers.py is tlab_tpu's, function for function."""
    import inspect
    from tlab_tpu.stats import spatial_registers as jsreg
    from tlab_tpu_torch.stats import spatial_registers as tsreg
    assert inspect.getsource(getattr(tsreg, name)) == \
        inspect.getsource(getattr(jsreg, name))


def test_spatial_registers_give_the_same_numbers():
    """The register table (238 names, their addends) and one accumulation
    of random base fields, exactly."""
    from tlab_tpu.stats import spatial_registers as jsreg
    from tlab_tpu_torch.stats import spatial_registers as tsreg
    assert tsreg.NAMES == jsreg.NAMES and len(tsreg.NAMES) == 238
    _same(tsreg.REGISTERS, jsreg.REGISTERS, "REGISTERS")
    rng = np.random.default_rng(0)
    shape = (5, 4, 3)
    keys = ("u", "v", "w", "p", "rho", "T")
    f = {k: rng.standard_normal(shape) for k in keys}
    grads = {a + b: rng.standard_normal(shape) for a in "uvw" for b in "xyz"}
    sgrads = {a + b: rng.standard_normal(shape) for a in "rpT"
              for b in "xyz"}
    out = []
    for mod in (tsreg, jsreg):
        base = mod.build_base(*(f[k] for k in keys), grads, sgrads,
                              visc=1e-3, z1=f["u"] ** 2)
        sums = np.zeros((len(mod.NAMES), 5, 4))
        mod.accumulate(sums, base)
        out.append(mod.as_table(sums, 2))
    _same(out[0], out[1], "as_table")


MIXTURE_COPIES = ("MixtureTable", "build_mixture", "_chemkin_molar_mass",
                  "read_chemkin")


@pytest.mark.parametrize("name", MIXTURE_COPIES)
def test_mixture_tables_code_is_the_original(name):
    import inspect
    from tlab_tpu.physics import mixtures as jmx
    from tlab_tpu_torch.physics import mixtures as tmx
    assert inspect.getsource(getattr(tmx, name)) == \
        inspect.getsource(getattr(jmx, name))


@pytest.mark.parametrize("nondimensional", [True, False])
def test_mixture_tables_match(nondimensional):
    """Every named mixture's caloric table, field for field, exactly; the
    species data and the mixture list alike."""
    from tlab_tpu.physics import mixtures as jmx
    from tlab_tpu_torch.physics import mixtures as tmx
    assert tmx.MIXTURES == jmx.MIXTURES
    assert tmx._COMBUSTION_SPECIES == jmx._COMBUSTION_SPECIES
    for name in tmx.MIXTURES:
        _same(tmx.build_mixture(name, nondimensional),
              jmx.build_mixture(name, nondimensional), name)


@pytest.mark.parametrize("name", ["SpatialStats._c",
                                  "SpatialStats.favre_station_table"])
def test_favre_table_code_is_the_original(name):
    import importlib
    import inspect

    def get(pkg):
        obj = importlib.import_module(f"{pkg}.stats.spatial")
        for part in name.split("."):
            obj = getattr(obj, part)
        return inspect.getsource(obj)

    assert get("tlab_tpu_torch") == get("tlab_tpu")


def test_reference_formats_copy_is_the_original():
    """io/reference_formats.py (NumPy only) is tlab_tpu's, line for line."""
    import inspect
    from tlab_tpu.io import reference_formats as jrf
    from tlab_tpu_torch.io import reference_formats as trf
    assert inspect.getsource(trf) == inspect.getsource(jrf)
