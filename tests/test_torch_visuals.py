"""`visuals` (postprocess.run_visuals and the [PostProcessing] ParamVisuals
menu) through the port's CLI (--device cpu --x64) and tlab_tpu's (--cpu
--x64) on the same restart files, float64 on the CPU, every file compared.

Cases, each with every menu number its file can reach (tlab_tpu's menu,
tlab_tpu/tools/cli.py:437-517):
- a 32x24x16 copy of tests/data/case01_small3d.ini, stratified and rotating,
  PressureDecomposition=resolved, with 500 tracers for ParticleDensity
  (iscal_offset 9); the same with a Subdomain and Format=general;
- a 32x24x16 copy of examples/cloudtop_anelastic (AirWater, offset 12) with
  gray radiation; a three-scalar copy with Damkohler > 0 for Supsat;
- that copy with the AirWaterLinear mixture (offset 12);
- tests/data/case02_small3d.ini (compressible: Density and Temperature
  from the conservative fields) and tests/data/case93_small3d.ini (IBM:
  EpsSolid).

Limit: a visual file (raw f4) equals tlab_tpu's, or differs by one f4 ulp
where the float64 values round on a tie, or by 1e-13 of max(1, the field's
max): the float64 round-off of a field that vanishes analytically (the x
gradient of a y profile) or of a cancelling sum.  Format=general files
(float64, the restart format) are held by the same rule after rounding to
f4, with equal headers: GradientRi divides by (du/dy)^2, which amplifies
the float64 round-off to 5e-10 where du/dy nearly vanishes."""
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_anelastic import CLOUD_SMALL, CLOUDTOP, _edit
from tlab_tpu.tools import cli as jcli
from tlab_tpu_torch.io import fields_io as tio
from tlab_tpu_torch.tools import cli as tcli

DATA = os.path.join(os.path.dirname(__file__), "data")
SMALL = [("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
         ("points_1=129", "points_1=33"), ("points_1=64", "points_1=24")]
TORCH = ["--device", "cpu", "--x64"]
JAX = ["--cpu", "--x64"]
ROUNDOFF = 1e-13

torch.set_num_threads(2)


def _data_case(name, edits=(), extra=""):
    with open(os.path.join(DATA, name)) as fh:
        text = fh.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new, 1)
    return text + extra


def _menu(numbers, keys=""):
    return ("\n[PostProcessing]\nFiles=0\nParamVisuals="
            + ",".join(str(n) for n in numbers) + "\n" + keys)


RADIATION = ("\n[Infrared]\nType=gray\nScalar=1\n"
             "BoundaryConditions=0.2, 1.0\nAbsorptionComponent1=5.0\n")
STRATIFIED = ("\n[Gravity]\nVector=0.0,-1.0,0.0\nParameters=1.0\n"
              "\n[Rotation]\nType=explicit\nVector=0.0,1.0,0.0\n"
              "\n[Particles]\nType=Tracer\nNumber=500\nDiamIniP=0.4\n"
              "YMeanRelativeIniP=0.5\n")


def _plain(keys=""):
    edits = SMALL + [("[Main]\n", "[Main]\nTermBodyForce=Linear\n"),
                     ("[Parameters]\n", "[Parameters]\nFroude=1.0\n"
                      "Rossby=1.0\n")]
    # offset 9: 1-5, 8 (resolved), 9, 10-19, 21, 23, 24, 27-29
    numbers = [1, 2, 3, 4, 5, 8, 9, *range(10, 20), 21, 23, 24, 27, 28, 29]
    return _data_case("case01_small3d.ini", edits, STRATIFIED + _menu(
        numbers, "PressureDecomposition=resolved\n" + keys))


def _cloud(mixture="AirWater"):
    text = _edit(CLOUDTOP.read_text(), CLOUD_SMALL) + RADIATION
    text = text.replace("Mixture=AirWater", f"Mixture={mixture}", 1)
    # offset 12: 1-5, 8, 9 (scalars + Liquid), the species 10-12, 13-32
    # but ParticleDensity (30, the plain case's)
    numbers = [1, 2, 3, 4, 5, 8, *range(9, 30), 31, 32]
    return text + _menu(numbers)


def _three_scalars(text):
    """The cloud-top copy with a third (prognostic liquid) scalar."""
    text = text.replace("Schmidt=1.0,1.0", "Schmidt=1.0,1.0,1.0", 1)
    text = text.replace("Froude=0.0254", "Froude=0.0254\nDamkohler=1.0", 1)
    return text.replace(
        "Scalar2Jmax=dirichlet",
        "Scalar2Jmax=dirichlet\nScalar3Jmin=dirichlet\n"
        "Scalar3Jmax=dirichlet", 1)


CASES = {
    "plain": _plain(),
    "subdomain": _plain("Subdomain=3,30,2,20,5,12\nFormat=general\n"),
    "airwater": _cloud(),
    "airwaterlinear": _cloud("AirWaterLinear\nParameters=-2.0,0.5,0.1"),
    "compressible": _data_case(
        "case02_small3d.ini", extra=_menu([1, 2, 3, 4, 5, 6, 7, 9, 13, 15,
                                           16, 19, 24])),
    "ibm": _data_case("case93_small3d.ini", extra=_menu([17, 18, 29])),
}


def _restarts(d, text, seed):
    """The port's `ini` (and `inipart` where the case has particles),
    then seeded noise on the fields: every derived field nonzero."""
    (d / "tlab.ini").write_text(text)
    common = ["--ini", str(d / "tlab.ini"), "--outdir", str(d), *TORCH]
    assert tcli.main(["ini", *common]) == 0
    if "[Particles]" in text:
        assert tcli.main(["inipart", *common]) == 0
    rng = np.random.default_rng(seed)
    for name in sorted(os.listdir(d)):
        if name.startswith(("flow.0.", "scal.0.")):
            a, params, _ = tio.read_field(str(d / name))
            noise = rng.standard_normal(a.shape)
            scale = 1e-3 * max(np.max(np.abs(a)), 1e-3)
            tio.write_field(str(d / name), a + scale * noise, 0, params)


def _visuals(top, name, text, extra=(), seed=0):
    """(port's directory, tlab_tpu's) after both CLIs' `visuals` on the
    same restarts."""
    t, j = top / name / "t", top / name / "j"
    t.mkdir(parents=True)
    j.mkdir()
    _restarts(t, text, seed)
    for f in os.listdir(t):
        shutil.copy(t / f, j / f)
    for d, main, flags in ((t, tcli.main, TORCH), (j, jcli.main, JAX)):
        assert main(["visuals", "--ini", str(d / "tlab.ini"), "--outdir",
                     str(d), *flags, *extra]) == 0
    return t, j


def _close(a, b, what):
    """The module docstring's limit on two f4 files' values."""
    assert a.shape == b.shape and np.isfinite(a).all(), what
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    floor = ROUNDOFF * max(1.0, float(np.max(np.abs(b))))
    bad = (d > ulp) & (d > floor)
    assert not bad.any(), (what, int(bad.sum()), float(d.max()))


def _vis_files(d):
    return sorted(f for f in os.listdir(d) if f.startswith("vis"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    top = tmp_path_factory.mktemp("visuals")
    return {name: _visuals(top, name, text, seed=i)
            for i, (name, text) in enumerate(CASES.items())}


@pytest.mark.parametrize("case", list(CASES))
def test_menu_writes_the_same_files(runs, case):
    t, j = runs[case]
    names = _vis_files(t)
    assert names == _vis_files(j) and len(names) > 3
    general = "Format=general" in CASES[case]
    for n in names:
        if general:
            a, pa, ia = tio.read_field(str(t / n))
            b, pb, ib = tio.read_field(str(j / n))
            assert (pa, ia) == (pb, ib), n
            a, b = a.astype("<f4"), b.astype("<f4")
        else:
            a = np.fromfile(t / n, "<f4")
            b = np.fromfile(j / n, "<f4")
        _close(a, b, (case, n))


def test_menu_names(runs):
    """The names each case's menu selects, as tlab_tpu's file sets show
    them: the offsets, the species, resolved, EpsSolid."""
    got = {c: {n.split(".", 1)[1] for n in _vis_files(runs[c][0])}
           for c in CASES}
    assert {"PressureCoriolis", "PressureBuoyancy", "PressureTotal",
            "ParticleDensity", "LogBuoyancySource", "VorticityVector3",
            "StressTensoryz", "ReynoldsTensorvw", "Gz"} <= got["plain"]
    assert {"H2Ov", "Air", "H2Ol", "Liquid", "Scalar2", "Radiation",
            "RelativeHumidity", "Cvb"} <= got["airwater"]
    assert {"Chi", "Psi", "Liquid", "LogBuoyancySource"} <= \
        got["airwaterlinear"]
    assert {"Density", "Temperature", "VelocityX"} <= \
        got["compressible"]
    assert "EpsSolid" in got["ibm"]


def test_subdomain_is_the_slice_of_the_whole_field(runs):
    """[PostProcessing] Subdomain (1-based, inclusive): the port's file is
    the slice of the field the whole-domain run writes."""
    full, sub = runs["plain"][0], runs["subdomain"][0]
    a = tio.read_field(str(sub / "vis0.VelocityX"))[0]
    u = tio.read_field(str(sub / "flow.0.1"))[0]
    assert np.array_equal(a, u[2:30, 1:20, 4:12])
    assert a.shape == (28, 19, 8)
    grid = tio.read_visual(str(full / "vis0.Enstrophy"), (32, 24, 16))
    assert np.isfinite(grid).all()


def test_velocity_file_is_the_restart_in_f4(runs):
    t, _ = runs["plain"]
    u = tio.read_field(str(t / "flow.0.1"))[0]
    got = np.fromfile(t / "vis0.VelocityX", "<f4")
    assert np.array_equal(got, u.transpose(2, 1, 0).astype("<f4").ravel())


def test_supsat_matches(tmp_path):
    """Supsat (the non-equilibrium AirWater state, three scalars,
    Damkohler > 0) and menu 7 of that case, which names it, by --fields."""
    text = _three_scalars(_cloud())
    t, j = _visuals(tmp_path, "supsat", text,
                    extra=["--fields", "Supsat,LogPotentialEnstrophy,"
                           "Liquid,H2Ol"], seed=7)
    assert _vis_files(t) == _vis_files(j) == [
        "vis0.H2Ol", "vis0.Liquid", "vis0.LogPotentialEnstrophy",
        "vis0.Supsat"]
    for n in _vis_files(t):
        _close(np.fromfile(t / n, "<f4"), np.fromfile(j / n, "<f4"), n)
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.runtime import Simulation
    text = text.replace("ParamVisuals=", "ParamVisuals=7,", 1)
    case = load_case(Ini(text=text))
    sim = Simulation.from_case(case, dtype=torch.float64, device="cpu")
    assert tcli.visual_menu(case, sim)[:2] == ("Temperature", "Supsat")


@pytest.mark.parametrize("case, number, error, match", [
    ("plain", 6, ValueError, "Density"),
    ("plain", 7, ValueError, "Temperature"),
    ("compressible", 8, KeyError, "ell")])
def test_entries_a_case_cannot_serve_raise(tmp_path, case, number, error,
                                           match):
    """Menu 6 and 7 (Density, Temperature) of an incompressible case, and
    8 past its first name (the diagnostic pressure: the compressible set
    has no Poisson plan) of a compressible one: both CLIs raise alike."""
    text = CASES[case].replace("ParamVisuals=", f"ParamVisuals={number},", 1)
    t = tmp_path / "t"
    t.mkdir()
    _restarts(t, text, 0)
    for main, flags in ((tcli.main, TORCH), (jcli.main, JAX)):
        with pytest.raises(error, match=match):
            main(["visuals", "--ini", str(t / "tlab.ini"), "--outdir",
                  str(t), *flags])


def test_no_menu_writes_enstrophy(tmp_path):
    text = _data_case("case01_small3d.ini", SMALL)
    t = tmp_path / "t"
    t.mkdir()
    _restarts(t, text, 1)
    assert tcli.main(["visuals", "--ini", str(t / "tlab.ini"), "--outdir",
                      str(t), "--files", "0", *TORCH]) == 0
    assert _vis_files(t) == ["vis0.Enstrophy"]


def chip_pressure_reference(top) -> dict:
    """chip_smoke.py's 16a pressure reference (its PRESSURE_VISUALS of 7a's
    case at SMALL_GRID on its seeded fields): {name: {"jax64", "jax32",
    "port64", "port32"}} as float64 tensors; tlab_tpu's float64 and float32
    solves, the port's float64 solve and its float32 `visuals` file."""
    import chip_smoke as cs
    import jax.numpy as jnp
    from tlab_tpu.config import Ini as JIni, load_case as jload_case
    from tlab_tpu.dycore.pressure import pressure_boussinesq as jpressure
    from tlab_tpu.dycore.state import State as JState
    from tlab_tpu.runtime import Simulation as JSimulation
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.convert import state_from_numpy
    from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
    from tlab_tpu_torch.runtime import Simulation
    text = cs.edit_case(cs.visuals_case(), cs.SMALL_GRID)
    out = {n: {} for n in cs.PRESSURE_VISUALS}

    def solves(pressure, P, st, zero):
        return zip(cs.PRESSURE_VISUALS, (
            pressure(P, st, "resolved"),
            pressure(P, st._replace(u=zero, v=zero, w=zero))))

    jcase = jload_case(JIni(text=text))
    for bits, dtype in ((32, jnp.float32), (64, jnp.float64)):
        jsim = JSimulation.from_case(jcase, dtype=dtype)
        fields = cs.pressure_witness_fields(tuple(jsim.grid.shape),
                                            jsim.grid.y.nodes)
        js = JState(*(jnp.asarray(a, dtype) for a in fields))
        for n, p in solves(jpressure, jsim.P, js, jnp.zeros_like(js.u)):
            out[n][f"jax{bits}"] = torch.from_numpy(
                np.array(p, np.float64))
    sim = Simulation.from_case(load_case(Ini(text=text)),
                               dtype=torch.float64, device="cpu")
    st = state_from_numpy(*fields, "cpu", torch.float64)
    for n, p in solves(pressure_boussinesq, sim.P, st,
                       torch.zeros_like(st.u)):
        out[n]["port64"] = p
    top.mkdir(parents=True, exist_ok=True)
    (top / "tlab.ini").write_text(text)
    tio.write_state(str(top / "flow"), str(top / "scal"), 0, st, 0.0,
                    sim.nsp.visc)
    assert tcli.main(["visuals", "--ini", str(top / "tlab.ini"), "--outdir",
                      str(top), "--device", "cpu", "--fields",
                      ",".join(cs.PRESSURE_VISUALS)]) == 0
    for n in cs.PRESSURE_VISUALS:
        out[n]["port32"] = torch.from_numpy(tio.read_visual(
            str(top / f"vis0.{n}"), sim.grid.shape))
    return out


def _drift(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_chip_smoke_pressure_reference(tmp_path):
    """chip_smoke.py's constants are tlab_tpu's: the float64 stats within
    PRESSURE_VISUAL_TOL of max|p|, the float32 drift within 5%; the port's
    float64 solve equal to tlab_tpu's to round-off, its float32 file held
    as the card's is (2x tlab_tpu's drift and the f4 rounding)."""
    import chip_smoke as cs
    ref = chip_pressure_reference(tmp_path)
    for n, r in ref.items():
        scale = float(r["jax64"].abs().max())
        stats = cs.pressure_stats(r["jax64"])
        assert max(abs(a - b) for a, b in zip(
            stats, cs.PRESSURE_VISUAL_FP64[n])) <= \
            cs.PRESSURE_VISUAL_TOL * scale, (n, stats)
        assert _drift(r["jax32"], r["jax64"]) == pytest.approx(
            cs.PRESSURE_VISUAL_WITNESS[n], rel=0.05), n
        assert _drift(r["port64"], r["jax64"]) <= 1e-10, n
        assert _drift(r["port32"], r["port64"]) <= \
            2.0 * cs.PRESSURE_VISUAL_WITNESS[n] + 2.0 ** -24, n


if __name__ == "__main__":
    # chip_smoke.py's PRESSURE_VISUAL_FP64 and PRESSURE_VISUAL_WITNESS:
    # PYTHONPATH=. python tests/test_torch_visuals.py
    import pathlib
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke as cs
    with tempfile.TemporaryDirectory() as d:
        ref = chip_pressure_reference(pathlib.Path(d))
    print("PRESSURE_VISUAL_FP64 =",
          {n: cs.pressure_stats(r["jax64"]) for n, r in ref.items()})
    print("PRESSURE_VISUAL_WITNESS =",
          {n: float(f"{_drift(r['jax32'], r['jax64']):.4g}")
           for n, r in ref.items()})
    print("port float32 file against float64:",
          {n: _drift(r["port32"], r["port64"]) for n, r in ref.items()})
