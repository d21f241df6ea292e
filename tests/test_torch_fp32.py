"""The port held to tlab_tpu in float32 on the CPU, where both packages run
(until now the port's float32 was held to its own float64 only).

1. The pressure projection of a smooth divergent field, one
   _solve_pressure at dte = 0.01 with zero tendencies on the plans of
   examples/shear3d/tlab.ini at 128x64x64: max|div u| after
   over before, off the wall rows, in float32 in both packages and in
   float64.  The port's float32 figure may be no worse than 2x tlab_tpu's
   (whose plan is float32 throughout: x64 off reads the same, 6.8e-4).
2. The explicit buoyancy and the saturation adjustment on the cloudtop
   background (examples/cloudtop_anelastic, ScaleHeight 8700) plus seeded
   noise, float32 inputs, against the float64 result: max|x32 - x64| /
   max|x64|.  The port evaluates them in float64 and may be no worse than
   2x tlab_tpu's figure with x64 on (the test process's, where NumPy
   float64 constants promote tlab_tpu's float32 arithmetic to float64).
   tlab_tpu with x64 off (its CLI default) is measured in a subprocess and
   recorded: its float32 polynomial cancels (b off by ~90%).
3. The cloudtop stepped in float32: a 32x96x16 copy of
   examples/cloudtop_anelastic with a y-shaped velocity perturbation (as
   chip_smoke.py's 8d), as the example (Boussinesq set) and with
   Equations=anelastic, gray radiation and sedimentation (chip_smoke.py's
   8b), 5 RK steps of dt = 0.06 (the adaptive dt of the start) from
   tlab_tpu's initial state, float32
   against float64 in each package: max|q32 - q64| / max|q64| of the
   velocity (u, v, w as one vector) and of the scalars, both packages'
   velocity also split into the fluctuations about the plane means and the
   plane means (a uniform v that the projection's singular mode leaves)
   over max|u64|.  tlab_tpu runs in float32 with x64 on and its source
   hook's result cast to float32, so that its thermodynamics evaluate in
   float64 as the port's do.  The port's figures may be no worse than 2x
   tlab_tpu's: the velocity's float32 drift (~5e-4 of a velocity of ~1e-3
   driven by a buoyancy of ~1e-2) is the scheme's, not the port's.
The figures are printed (pytest -s) for ROADMAP section C and PERF.md."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore import incompressible as jdyn
from tlab_tpu.physics import thermo as jthermo
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.tools.initialize import initial_state as jinitial_state
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as tdyn
from tlab_tpu_torch.physics import thermo as tthermo
from tlab_tpu_torch.runtime import Simulation, grid_from_case, make_anelastic

REPO = pathlib.Path(__file__).resolve().parent.parent
FACTOR = 2.0

torch.set_num_threads(2)

SHEAR = (REPO / "examples" / "shear3d" / "tlab.ini").read_text()
for _old, _new in (("Imax=512", "Imax=128"), ("Jmax=256", "Jmax=64"),
                   ("Kmax=256", "Kmax=64"), ("points_1=513", "points_1=129"),
                   ("points_1=256", "points_1=64"),
                   ("points_1=257", "points_1=65")):
    assert _old in SHEAR
    SHEAR = SHEAR.replace(_old, _new)
CLOUD = (REPO / "examples" / "cloudtop_anelastic" / "tlab.ini").read_text()
for _old, _new in (("Imax=256", "Imax=32"), ("Jmax=192", "Jmax=192"),
                   ("Kmax=128", "Kmax=16"), ("points_1=257", "points_1=33"),
                   ("points_1=129", "points_1=17")):
    assert _old in CLOUD
    CLOUD = CLOUD.replace(_old, _new)


def _smooth(grid):
    """phase 7's smooth divergent field (chip_smoke.smooth_projection)."""
    x = grid.x.nodes[:, None, None]
    y = grid.y.nodes[None, :, None]
    z = grid.z.nodes[None, None, :]
    kx, kz = 2 * np.pi / grid.x.scale, 2 * np.pi / grid.z.scale
    ly = float(grid.y.nodes[-1])
    env = np.sin(np.pi * y / ly)
    one = np.ones(grid.shape)
    return ((np.sin(kx * x) + 0.3 * np.cos(2 * kx * x + kz * z)) * env,
            0.2 * np.sin(2 * np.pi * y / ly) * np.cos(kx * x) * one,
            0.4 * np.sin(kz * z) * np.cos(kx * x) * env)


def _reduction(dyn, P, fields, dte=0.01):
    u, v, w = fields
    zero = 0.0 * u
    dpdx, dpdy, dpdz, _ = dyn._solve_pressure(P, u, v, w, zero, zero, zero,
                                              dte)
    d0 = dyn.divergence(P, u, v, w)
    d1 = dyn.divergence(P, u - dte * dpdx, v - dte * dpdy, w - dte * dpdz)
    return float(abs(d1[:, 1:-1]).max() / abs(d0[:, 1:-1]).max())


def _thermo_inputs():
    """The cloudtop background (float64) and its profiles plus noise."""
    case = load_case(Ini(text=CLOUD))
    grid = grid_from_case(case)
    ane = make_anelastic(case, grid, torch.float64, "cpu")
    nx, ny, nz = grid.shape
    y = grid.y.nodes
    rng = np.random.default_rng(0)
    s = np.stack([np.broadcast_to(p(y)[None, :, None], (nx, ny, nz))
                  for p in case.scal_profiles]) \
        + np.stack([1e-3, 1e-4])[:, None, None, None] \
        * rng.standard_normal((2, nx, ny, nz))
    bg = {k: v.numpy() for k, v in ane["bg"].items()}
    return ane["tp"], s, bg


def _thermo_errors(tp_j, s, bg, ref):
    """tlab_tpu's float32 figures of (b, T, ql) against the float64 ones."""
    s32 = s.astype(np.float32)
    bg32 = {k: v.astype(np.float32) for k, v in bg.items()}
    b = jthermo.buoyancy_explicit(tp_j, jnp.asarray(s32), bg32)
    T, ql = jthermo.equilibrium_T_ql(
        tp_j, jnp.asarray(s32[0]), jnp.asarray(s32[1]),
        jnp.asarray(bg32["p"])[None, :, None],
        jnp.asarray(bg32["ep"])[None, :, None])
    return {k: float(np.max(np.abs(np.asarray(a, np.float64) - ref[k]))
                     / np.max(np.abs(ref[k])))
            for k, a in (("b", b), ("T", T), ("ql", ql))}


_X64_OFF = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64
import jax.numpy as jnp
from tlab_tpu.physics import thermo
sys.path.insert(0, sys.argv[1] + "/tests")
import test_torch_fp32 as t
d = np.load(sys.argv[2], allow_pickle=True)
tp = thermo.ThermoParams(**json.loads(str(d["tp"])))
ref = {k: d["ref_" + k] for k in ("b", "T", "ql")}
bg = {k: d["bg_" + k] for k in ("p", "rho", "ep", "T")}
print(json.dumps(t._thermo_errors(tp, d["s"], bg, ref)))
"""


@pytest.fixture(scope="module")
def figures(tmp_path_factory):
    out = {}
    # 1. the projection
    case_t, case_j = load_case(Ini(text=SHEAR)), jload_case(JIni(text=SHEAR))
    for name, dtype in (("port32", torch.float32), ("port64", torch.float64)):
        sim = Simulation.from_case(case_t, dtype=dtype, device="cpu")
        fields = [torch.as_tensor(a).to(dtype) for a in _smooth(sim.grid)]
        out[f"projection_{name}"] = _reduction(tdyn, sim.P, fields)
    jsim = JSimulation.from_case(case_j, dtype=jnp.float32)
    fields = [jnp.asarray(a, jnp.float32) for a in _smooth(jsim.grid)]
    out["projection_jax32"] = _reduction(jdyn, jsim.P, fields)
    # 2. the thermodynamics
    tp, s, bg = _thermo_inputs()
    tp_j = jthermo.ThermoParams(**{f: getattr(tp, f)
                                   for f in tp.__dataclass_fields__})
    b64 = np.asarray(jthermo.buoyancy_explicit(tp_j, jnp.asarray(s), bg))
    T64, ql64 = (np.asarray(a) for a in jthermo.equilibrium_T_ql(
        tp_j, jnp.asarray(s[0]), jnp.asarray(s[1]),
        jnp.asarray(bg["p"])[None, :, None],
        jnp.asarray(bg["ep"])[None, :, None]))
    ref = {"b": b64, "T": T64, "ql": ql64}
    s32 = torch.from_numpy(s.astype(np.float32))
    bg32 = {k: torch.from_numpy(v.astype(np.float32)) for k, v in bg.items()}
    T32, ql32 = tthermo.equilibrium_state(tp, s32, bg32)
    b32 = tthermo.buoyancy_explicit(tp, s32, bg32)
    for k, a in (("b", b32), ("T", T32), ("ql", ql32)):
        assert a.dtype == torch.float32
        out[f"{k}_port32"] = float(np.max(np.abs(a.double().numpy() - ref[k]))
                                   / np.max(np.abs(ref[k])))
    for k, v in _thermo_errors(tp_j, s, bg, ref).items():
        out[f"{k}_jax32_x64on"] = v
    # tlab_tpu with x64 off, in a fresh interpreter
    npz = tmp_path_factory.mktemp("fp32") / "inputs.npz"
    np.savez(npz, s=s, tp=json.dumps({f: getattr(tp, f) for f in
                                      tp.__dataclass_fields__}),
             **{"bg_" + k: v for k, v in bg.items()},
             **{"ref_" + k: v for k, v in ref.items()})
    proc = subprocess.run([sys.executable, "-c", _X64_OFF, str(REPO),
                           str(npz)], capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    for k, v in json.loads(proc.stdout.splitlines()[-1]).items():
        out[f"{k}_jax32_x64off"] = v
    print("\nfloat32 figures:", json.dumps(out, indent=1))
    return out


def test_projection_in_float32_is_no_worse_than_tlab_tpus(figures):
    assert figures["projection_port64"] <= 1e-4
    assert figures["projection_port32"] <= FACTOR * figures["projection_jax32"]


@pytest.mark.parametrize("what", ["b", "T", "ql"])
def test_thermodynamics_in_float32_are_no_worse_than_tlab_tpus(figures,
                                                               what):
    assert figures[f"{what}_port32"] <= FACTOR * figures[f"{what}_jax32_x64on"]
    # the float32 polynomial of tlab_tpu's CLI default (x64 off) cancels
    assert figures[f"{what}_jax32_x64off"] > 100 * figures[f"{what}_port32"]


# 3. the cloudtop stepped in float32
CLOUD_STEP = (REPO / "examples" / "cloudtop_anelastic" / "tlab.ini") \
    .read_text()
for _old, _new in (("Imax=256", "Imax=32"), ("Jmax=192", "Jmax=96"),
                   ("Kmax=128", "Kmax=16"), ("points_1=257", "points_1=33"),
                   ("points_1=192", "points_1=96"),
                   ("points_1=129", "points_1=17"),
                   ("[IniFields]\n", "[IniFields]\nProfileIniK=Gaussian\n"
                    "ThickIniK=0.02\nYMeanRelativeIniK=0.75\n")):
    assert _old in CLOUD_STEP
    CLOUD_STEP = CLOUD_STEP.replace(_old, _new)
CLOUD_CASES = {
    "boussinesq": CLOUD_STEP,
    "anelastic": CLOUD_STEP.replace(
        "Equations=incompressible", "Equations=anelastic").replace(
        "[Parameters]\n", "[Parameters]\nSettling=0.05\n")
    + "\n[Infrared]\nType=gray\nScalar=1\nBoundaryConditions=0.2, 1.0\n"
      "AbsorptionComponent1=5.0\nAbsorptionComponent2=0.1\n"
      "AbsorptionComponent3=0.01\nBeta=0.1\n"
      "\n[Sedimentation]\nType=airwater\n"}
CLOUD_DT, CLOUD_STEPS = 0.06, 5


def _drift(a, b):
    """max|a - b| / max|b| of the velocity and of the scalars, then of the
    velocity's fluctuations about its plane means and of the plane means
    over the velocity's max."""
    va, vb = np.stack(a[:3]), np.stack(b[:3])
    ma = va.mean(axis=(1, 3), keepdims=True)
    mb = vb.mean(axis=(1, 3), keepdims=True)
    return (np.abs(va - vb).max() / np.abs(vb).max(),
            np.abs(a[3] - b[3]).max() / np.abs(b[3]).max(),
            np.abs(va - ma - vb + mb).max() / np.abs(vb - mb).max(),
            np.abs(ma - mb).max() / np.abs(vb).max())


@pytest.mark.parametrize("name", list(CLOUD_CASES))
def test_cloudtop_steps_in_float32_drift_as_tlab_tpus(name):
    text = CLOUD_CASES[name]
    jcase, tcase = jload_case(JIni(text=text)), load_case(Ini(text=text))
    jsim64 = JSimulation.from_case(jcase)
    start = [np.asarray(a, np.float64)
             for a in jinitial_state(jsim64, seed=0)[:4]]
    out = {}
    for bits, jdtype in ((32, jnp.float32), (64, jnp.float64)):
        jsim = JSimulation.from_case(jcase, dtype=jdtype) if bits == 32 \
            else jsim64
        if bits == 32:
            hook = jsim.P["bodyforce"]
            jsim.P["bodyforce"] = lambda P, st, *h, **kw: tuple(
                a.astype(jnp.float32) for a in hook(P, st, *h, **kw))
        st = jdyn.State(*(jnp.asarray(a, jdtype) for a in start))
        for _ in range(CLOUD_STEPS):
            st, _ = jdyn.rk_step(jsim.P, st, CLOUD_DT)
        assert st.u.dtype == jdtype and st.s.dtype == jdtype
        out[f"jax{bits}"] = [np.asarray(a, np.float64) for a in st[:4]]
        dtype = {32: torch.float32, 64: torch.float64}[bits]
        sim = Simulation.from_case(tcase, dtype=dtype, device="cpu")
        st = state_from_numpy(*start, "cpu", dtype)
        for _ in range(CLOUD_STEPS):
            st, _ = tdyn.rk_step(sim.P, st, CLOUD_DT)
        out[f"port{bits}"] = [a.double().numpy() for a in st[:4]]
    port, jax = _drift(out["port32"], out["port64"]), \
        _drift(out["jax32"], out["jax64"])
    print(f"\ncloudtop {name} float32 drift (velocity, scalars; the "
          f"fluctuations, the plane means): port "
          + " ".join(f"{x:.3e}" for x in port)
          + "; tlab_tpu " + " ".join(f"{x:.3e}" for x in jax))
    # the float64 runs are the same run: round-off, in a velocity of 1e-3
    # driven by a buoyancy that is a difference of O(1) densities (5e-8 of
    # the fluctuations measured)
    assert max(_drift(out["port64"], out["jax64"])) <= 1e-6
    assert port[0] <= FACTOR * jax[0] and port[1] <= FACTOR * jax[1]


# 4. the compressible shear layer stepped in float32: tests/data/
# case02_small3d.ini at its own 128x64x16 (Equations=internal,
# skew-symmetric), 5 RK4 steps of the start's adaptive dt from tlab_tpu's
# initial state, float32 against float64 in each package.  The port's
# figure may be no worse than 2x tlab_tpu's: the witness of chip_smoke.py's
# 12c limit, which holds the card's float32 run to 2x the figure printed
COMP_TEXT = (REPO / "tests" / "data" / "case02_small3d.ini").read_text()
COMP_DT, COMP_STEPS = 2.2e-3, 5
C14_DT = 1.28e-5


def _comp_drift(a, b):
    """max over the conservative fields of max|a - b| / max|b|."""
    return max(float(np.abs(x - y).max() / np.abs(y).max())
               for x, y in zip(a, b))


def test_compressible_steps_in_float32_drift_as_tlab_tpus():
    import jax
    from tlab_tpu.dycore import compressible as jcomp
    from tlab_tpu.tools.initialize import compressible_initial_state
    from tlab_tpu_torch.dycore import compressible as tcomp
    jcase, tcase = jload_case(JIni(text=COMP_TEXT)), \
        load_case(Ini(text=COMP_TEXT))
    jsim64 = JSimulation.from_case(jcase)
    start = [np.asarray(a, np.float64)
             for a in compressible_initial_state(jsim64, seed=0)]
    out = {}
    for bits, jdtype in ((32, jnp.float32), (64, jnp.float64)):
        jsim = JSimulation.from_case(jcase, dtype=jdtype) if bits == 32 \
            else jsim64
        c = jsim.comp
        step = jax.jit(lambda U, P=jsim.P, c=c: jcomp.rk_step_compressible(
            P, U, COMP_DT, c["gamma"], c["mach"], jsim.nsp.visc,
            c["prandtl"], form=c["form"], energy=c["energy"],
            gvec=c["gvec"]))
        U = jcomp.CompState(*(jnp.asarray(a, jdtype) for a in start))
        for _ in range(COMP_STEPS):
            U = step(U)
        assert all(a.dtype == jdtype for a in U)
        out[f"jax{bits}"] = [np.asarray(a, np.float64) for a in U]
        dtype = {32: torch.float32, 64: torch.float64}[bits]
        sim = Simulation.from_case(tcase, dtype=dtype, device="cpu")
        c = sim.comp
        U = tcomp.CompState(*(torch.tensor(a, dtype=dtype) for a in start))
        for _ in range(COMP_STEPS):
            U = tcomp.rk_step_compressible(
                sim.P, U, COMP_DT, c["gamma"], c["mach"], sim.nsp.visc,
                c["prandtl"], form=c["form"], energy=c["energy"],
                gvec=c["gvec"])
        out[f"port{bits}"] = [a.double().numpy() for a in U]
    port = _comp_drift(out["port32"], out["port64"])
    jax_ = _comp_drift(out["jax32"], out["jax64"])
    print(f"\ncase02 float32 drift over {COMP_STEPS} steps (max over the "
          f"conservative fields): port {port:.3e}; tlab_tpu {jax_:.3e}")
    assert _comp_drift(out["port64"], out["jax64"]) <= 1e-10
    assert port <= FACTOR * jax_


# 5. the compressible AirWater set stepped in float32: tests/data/
# case14_small3d.ini as it is (32x48x8: the moist cloud top, NSCBC outflow,
# the relaxation buffer), 5 RK4 steps of dt C14_DT from tlab_tpu's float64
# initial state, float32 against float64 in each package, field by field.
# Both packages run the saturation Newton in float64 (tlab_tpu's airwater_re
# wrapped to take and give float64 inside its float32 run), so the drift is
# the scheme's; tlab_tpu with its float32 polynomial is measured beside it.
# The port's figures may be no worse than 2x tlab_tpu's: the witness of
# chip_smoke.py's 13d limit (C14_WITNESS)
AW_TEXT = (REPO / "tests" / "data" / "case14_small3d.ini").read_text()
AW_FIELDS = ("rho", "rhou", "rhov", "rhoE", "rhos")


def _aw_fields(U):
    """The fields 13d holds, as float64 NumPy (rhow is round-off only)."""
    return {"rho": U.rho, "rhou": U.rhou, "rhov": U.rhov, "rhoE": U.rhoE,
            "rhos": U.rhos[0]}


def _aw_run_jax(jcase, start, jdtype, newton64: bool):
    import contextlib
    from unittest import mock
    from tlab_tpu.dycore import compressible as jcomp
    re32 = jthermo.airwater_re

    def re64(tp, qt, e, rho, nr=3):
        out = re32(tp, *(jnp.asarray(a, jnp.float64) for a in (qt, e, rho)),
                   nr=nr)
        return tuple(a.astype(jnp.asarray(rho).dtype) for a in out)

    ctx = mock.patch.object(jthermo, "airwater_re", re64) if newton64 \
        else contextlib.nullcontext()
    with ctx:
        jsim = JSimulation.from_case(jcase, dtype=jdtype)
        U = jcomp.CompState(*(jnp.asarray(a, jdtype) for a in start))
        jsim.attach_buffer_compressible(U)
        c = jsim.comp
        for _ in range(5):
            U, _ = jcomp.rk_step_airwater(
                jsim.P, U, C14_DT, c["aw"], jsim.nsp.visc, c["prandtl"],
                c["schmidt"], nscbc=c["nscbc"], ly=c["ly"], gvec=c["gvec"],
                buffer=c["buffer"])
    return {k: np.asarray(v, np.float64) for k, v in _aw_fields(U).items()}


def _aw_run_port(tcase, start, dtype):
    from tlab_tpu_torch.dycore import compressible as tcomp
    sim = Simulation.from_case(tcase, dtype=dtype, device="cpu")
    U = tcomp.CompState(*(torch.tensor(a, dtype=dtype) for a in start))
    sim.attach_buffer_compressible(U)
    c = sim.comp
    for _ in range(5):
        U, _ = tcomp.rk_step_airwater(
            sim.P, U, C14_DT, c["aw"], sim.nsp.visc, c["prandtl"],
            c["schmidt"], nscbc=c["nscbc"], ly=c["ly"], gvec=c["gvec"],
            buffer=c["buffer"])
    return {k: v.double().numpy() for k, v in _aw_fields(U).items()}


def _field_drift(a, b):
    return {k: float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
            for k in AW_FIELDS}


def test_airwater_steps_in_float32_drift_as_tlab_tpus():
    from tlab_tpu.tools.initialize import compressible_initial_state
    sys.path.insert(0, str(REPO))
    import chip_smoke
    jcase, tcase = jload_case(JIni(text=AW_TEXT)), load_case(Ini(text=AW_TEXT))
    start = [np.asarray(a, np.float64) for a in compressible_initial_state(
        JSimulation.from_case(jcase))]
    jax64 = _aw_run_jax(jcase, start, jnp.float64, False)
    jax32 = _aw_run_jax(jcase, start, jnp.float32, True)
    port64 = _aw_run_port(tcase, start, torch.float64)
    port32 = _aw_run_port(tcase, start, torch.float32)
    port, jax_ = _field_drift(port32, port64), _field_drift(jax32, jax64)
    print(f"\ncase14 float32 drift over 5 steps of {C14_DT} by field: port "
          f"{port}; tlab_tpu (fp64 Newton) {jax_}")
    # the float64 runs agree but for the x momentum's round-off floor
    # (ROADMAP C): 1e-10 of each field's max, the momenta of rho c
    par = _field_drift(port64, jax64)
    assert all(par[k] <= 1e-10 for k in ("rho", "rhoE", "rhos")), par
    for k in AW_FIELDS:
        assert port[k] <= FACTOR * jax_[k], (k, port[k], jax_[k])
        # the witness chip_smoke.py holds the card to; the momenta's fp32
        # figures are round-off through a pressure gradient of p ~ 8.2e4
        # (one fp32 right-hand side is off by half of max|h| in either
        # package), so they move with the order of BLAS sums: 25%
        assert jax_[k] == pytest.approx(chip_smoke.C14_WITNESS[k], rel=0.25)


@pytest.mark.slow
def test_airwater_with_tlab_tpus_float32_polynomial():
    """What tlab_tpu's own float32 saturation polynomial does to Case14's
    five steps (ROADMAP C 19; printed for PERF.md): the density and energy
    drift as with its Newton in fp64, the x momentum more.  Slow: a third
    run of tlab_tpu, ~10 s, only to record the figure."""
    from tlab_tpu.tools.initialize import compressible_initial_state
    jcase = jload_case(JIni(text=AW_TEXT))
    start = [np.asarray(a, np.float64) for a in compressible_initial_state(
        JSimulation.from_case(jcase))]
    jax64 = _aw_run_jax(jcase, start, jnp.float64, False)
    poly = _field_drift(_aw_run_jax(jcase, start, jnp.float32, False), jax64)
    print(f"\ncase14 float32 drift, tlab_tpu with its fp32 polynomial: "
          f"{poly}")
    assert all(np.isfinite(v) for v in poly.values())


# 6. the diagnostic pressure (dycore/pressure.py) of chip_smoke.py's seeded
# shear-layer state at its 128x64x64 (pressure_witness_fields), float32
# against float64 in each package, for the decompositions phase 14 holds.
# The port's figure may be no worse than 2x tlab_tpu's; tlab_tpu's is the
# witness of phase 14's limit (PRESSURE_WITNESS)
@pytest.mark.parametrize("dcmp", ["total", "advection"])
def test_diagnostic_pressure_in_float32_drifts_as_tlab_tpus(dcmp):
    import chip_smoke
    from tlab_tpu.dycore.pressure import pressure_boussinesq as jpressure
    from tlab_tpu.dycore.state import State as JState
    from tlab_tpu_torch.convert import state_from_numpy
    from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
    text = chip_smoke.shear_case(chip_smoke.PRESSURE_SMALL, 1)
    jcase, tcase = jload_case(JIni(text=text)), load_case(Ini(text=text))
    out = {}
    for bits, jdtype, dtype in ((32, jnp.float32, torch.float32),
                                (64, jnp.float64, torch.float64)):
        jsim = JSimulation.from_case(jcase, dtype=jdtype)
        fields = chip_smoke.pressure_witness_fields(
            chip_smoke.PRESSURE_SMALL, jsim.grid.y.nodes)
        js = JState(*(jnp.asarray(a, jdtype) for a in fields))
        out[f"jax{bits}"] = np.asarray(jpressure(jsim.P, js, dcmp),
                                       np.float64)
        sim = Simulation.from_case(tcase, dtype=dtype, device="cpu")
        out[f"port{bits}"] = pressure_boussinesq(
            sim.P, state_from_numpy(*fields, "cpu", dtype), dcmp).double() \
            .numpy()

    def drift(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    port, jax_ = drift(out["port32"], out["port64"]), \
        drift(out["jax32"], out["jax64"])
    print(f"\ndiagnostic pressure ({dcmp}) at {chip_smoke.PRESSURE_SMALL}, "
          f"float32 against float64: port {port:.3e}; tlab_tpu {jax_:.3e}")
    assert drift(out["port64"], out["jax64"]) <= 1e-10
    assert port <= FACTOR * jax_
    assert chip_smoke.PRESSURE_WITNESS[dcmp] == pytest.approx(jax_, rel=0.05)
