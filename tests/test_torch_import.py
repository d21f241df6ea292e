"""The port imports no JAX and nothing of tlab_tpu: the machine with the
CUDA card has no JAX, and the port keeps its own copies of the NumPy
modules it needs.

Checked in a fresh interpreter, because this test process (conftest.py)
has imported JAX already."""
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_CLEAN = """
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
"""

_PROBE = """
import pkgutil, importlib, sys
import tlab_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tlab_tpu_torch.__path__,
                                               "tlab_tpu_torch.")]
for name in names:
    importlib.import_module(name)
""" + _CLEAN + """
print(*names)
print(len(names))
"""

_SMOKE_PROBE = """
import sys, runpy
runpy.run_path('chip_smoke.py', run_name='chip_smoke')
""" + _CLEAN

# a Simulation from a case file through the port alone, with JAX and
# tlab_tpu made unimportable as they are on the card's machine
_CASE_PROBE = """
import sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
import torch
from tlab_tpu_torch.config import load_case
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch import entry
sim = Simulation.from_case(sys.argv[1], dtype=torch.float64, device="cpu")
assert tuple(sim.P["sizes"]) == tuple(sim.grid.shape)
state = state_from_numpy(
    *entry.initial_fields(sim.grid, 0, len(sim.case.schmidt)),
    device="cpu", dtype=torch.float64)
state, _ = dyn.rk_step(sim.P, state, 1e-3)
assert bool(torch.isfinite(state.u).all())
try:
    Simulation.from_case(sys.argv[1])
except RuntimeError as e:
    assert "CUDA is not available" in str(e), e
else:
    assert torch.cuda.is_available()
print(*sim.grid.shape)
"""


# ini -> dns through the port's command line, the same way
_CLI_PROBE = """
import os, sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
from tlab_tpu_torch.tools import cli
import tlab_tpu_torch.tools.dns, tlab_tpu_torch.tools.initialize
import tlab_tpu_torch.io.fields_io, tlab_tpu_torch.stats.averages
import tlab_tpu_torch.utils.fortran_fmt, tlab_tpu_torch.utils.nrrandom
import tlab_tpu_torch.utils.trace
common = ["--ini", sys.argv[1], "--outdir", sys.argv[2], "--device", "cpu",
          "--x64"]
assert cli.main(["inigrid", *common]) == 0
assert cli.main(["ini", *common]) == 0
assert cli.main(["dns", *common, "--steps", "2"]) == 0
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
print(*sorted(os.listdir(sys.argv[2])))
"""


def _run(probe, *args):
    return subprocess.run([sys.executable, "-c", probe, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


# the modules of the rank mesh, each among those the probe imports
MESH_MODULES = ("tlab_tpu_torch.parallel", "tlab_tpu_torch.parallel.mesh",
                "tlab_tpu_torch.parallel.pencil",
                "tlab_tpu_torch.particles.parallel",
                "tlab_tpu_torch.io.sharded")


def test_port_imports_no_jax():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40     # every module was imported
    names = proc.stdout.split("\n")[-3].split()
    for name in MESH_MODULES:
        assert name in names, name


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports (its body runs only on a CUDA card)."""
    proc = _run(_SMOKE_PROBE)
    assert proc.returncode == 0, proc.stderr


def test_simulation_from_case_file_without_jax(tmp_path):
    """load_case and Simulation.from_case on a case file of the ported path
    (the golden slice's INI), one RK step, where neither JAX nor tlab_tpu
    can be imported; and the default device is the card, which raises
    where there is none."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from test_golden import INI
    finally:
        sys.path.pop(0)
    path = tmp_path / "tlab.ini"
    path.write_text(INI)
    proc = _run(_CASE_PROBE, str(path))
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.split()) == 3


def test_simulation_with_the_new_options_without_jax(tmp_path):
    """The same probe on a case with a [Filter], a Helmholtz
    [PressureFilter], the skew-symmetric form, dealiasing, a stratification
    and a Coriolis force: fdm/filters.py, ops/elliptic.py, ops/filter.py and
    physics/{gravity,rotation,forcing}.py run where JAX cannot be
    imported."""
    text = (REPO / "tests" / "data" / "case_filter_small3d.ini").read_text()
    text = text.replace("TermAdvection=convective",
                        "TermAdvection=skewsymmetric")
    text += ("\n[Dealiasing]\nType=compact\n[Gravity]\nType=Linear\n"
             "Vector=0,-1,0\nParameters=1.0\n[Rotation]\nType=explicit\n"
             "Vector=0,1,0\n[Staggering]\nStaggerHorizontalPressure=yes\n")
    path = tmp_path / "tlab.ini"
    path.write_text(text)
    proc = _run(_CASE_PROBE, str(path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["64", "32", "16"]


def test_cloudtop_simulation_without_jax(tmp_path):
    """The same probe on examples/cloudtop_anelastic/tlab.ini (at 32x24x16),
    as the example and with Equations=anelastic, gray radiation and
    sedimentation: physics/{thermo,radiation,microphysics}.py and
    runtime.make_anelastic run where JAX cannot be imported."""
    text = (REPO / "examples" / "cloudtop_anelastic" / "tlab.ini").read_text()
    for old, new in (("Imax=256", "Imax=32"), ("Jmax=192", "Jmax=24"),
                     ("Kmax=128", "Kmax=16"), ("points_1=257", "points_1=33"),
                     ("points_1=192", "points_1=24"),
                     ("points_1=129", "points_1=17")):
        assert old in text
        text = text.replace(old, new)
    anelastic = (text.replace("Equations=incompressible",
                              "Equations=anelastic")
                 + "\n[Infrared]\nType=gray\nBoundaryConditions=0.2, 1.0\n"
                 "AbsorptionComponent1=5.0\n[Sedimentation]\nType=airwater\n"
                 ).replace("[Parameters]\n", "[Parameters]\nSettling=0.1\n")
    assert "Settling=0.1" in anelastic
    for i, case in enumerate((text, anelastic)):
        path = tmp_path / f"tlab{i}.ini"
        path.write_text(case)
        proc = _run(_CASE_PROBE, str(path))
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == ["32", "24", "16"]


def test_ini_and_dns_run_without_jax(tmp_path):
    """The port's CLI (tools.cli -> tools.initialize, tools.dns,
    io.fields_io, stats.averages, utils.*) writes a case's initial fields
    and steps it where neither JAX nor tlab_tpu can be imported."""
    ini = tmp_path / "tlab.ini"
    ini.write_text((REPO / "tests" / "data" / "case01_small3d.ini")
                   .read_text().replace("Statistics=5", "Statistics=2"))
    out = tmp_path / "run"
    proc = _run(_CLI_PROBE, str(ini), str(out))
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split("\n")[-2].split()
    for want in ("grid", "flow.0.1", "scal.0.1", "dns.out", "tlab.log",
                 "avg2", "avg2s1"):
        assert want in names, names


# the boundary machinery where JAX and tlab_tpu cannot be imported: the
# channel over bars (ibm.py) one step, and a spatial run with its strips,
# the filter sponge, an inflow box and the station statistics (dycore/
# buffer.py, dycore/inflow.py, stats/spatial.py, tools/dns.py)
_BOUNDARY_PROBE = """
import sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
import numpy as np, torch
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import incompressible as dyn
from tlab_tpu_torch.dycore.inflow import InflowBox
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import dns
from tlab_tpu_torch import entry
sim = Simulation.from_case(sys.argv[1], dtype=torch.float64, device="cpu")
assert "ibm" in sim.P
state = state_from_numpy(*entry.initial_fields(sim.grid, 0, 1),
                         device="cpu", dtype=torch.float64)
state, _ = dyn.rk_step(sim.P, state, 1e-3)
solid = sim.P["ibm"]["eps"] > 0.5
assert float(state.u[solid].abs().max()) == 0.0
sim = Simulation.from_case(load_case(Ini(text=open(sys.argv[2]).read())),
                           dtype=torch.float64, device="cpu")
nx, ny, nz = sim.grid.shape
u = np.broadcast_to(sim.case.vel_profiles[0](sim.grid.y.nodes)[None, :, None],
                    (nx, ny, nz))
z = np.zeros((nx, ny, nz))
box = InflowBox(fields={"v": 0.01 * np.ones((8, ny))}, u_convect=1.0, lx=1.0)
run = dns.run(sim, state_from_numpy(u, z, z, z[None], "cpu", torch.float64),
              outdir=sys.argv[3], n_steps=2, inflow=box)
assert sim.filter_sponge is not None and "buffer" in sim.P
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
print(run.itime)
"""


def test_boundary_machinery_runs_without_jax(tmp_path):
    """tests/data/case93_small3d.ini one RK step (the solids stay at rest)
    and the spatial jet of tests/test_cases.py with Type=both and an inflow
    box through dns.run, statistics at step 2: ibm.py, dycore/buffer.py,
    dycore/inflow.py and stats/spatial.py run where neither JAX nor
    tlab_tpu can be imported."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from test_cases import SPATIAL_JET
    finally:
        sys.path.pop(0)
    jet = tmp_path / "jet.ini"
    jet.write_text(SPATIAL_JET.replace("Type=relaxation", "Type=both")
                   .replace("Statistics=0", "Statistics=2")
                   .replace("Restart=60", "Restart=2"))
    out = tmp_path / "run"
    out.mkdir()
    proc = _run(_BOUNDARY_PROBE, str(REPO / "tests" / "data" /
                                     "case93_small3d.ini"), str(jet),
                str(out))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "2"
    names = sorted(p.name for p in out.iterdir())
    for want in ("avg_zt2", "st2.npz", "tlab.log"):
        assert want in names, names


# this slice's paths where JAX and tlab_tpu cannot be imported: the
# compressible case02 through the CLI (its initial state, two steps, the
# Favre tables), and an SMR91 Simulation one semi-implicit step
_SLICE_PROBE = """
import os, sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
import torch
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.dycore import implicit
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch import entry
common = ["--ini", sys.argv[1], "--outdir", sys.argv[3], "--device", "cpu",
          "--x64"]
assert cli.main(["ini", *common]) == 0
assert cli.main(["dns", *common, "--steps", "2"]) == 0
sim = Simulation.from_case(load_case(Ini(text=open(sys.argv[2]).read())),
                           dtype=torch.float64, device="cpu")
assert "ell_dd" in sim.P and sim.comp is None
state = state_from_numpy(*entry.initial_fields(sim.grid, 0, 1),
                         device="cpu", dtype=torch.float64)
state, _ = implicit.rk_step_implicit(sim.P, state, 1e-3)
assert bool(torch.isfinite(state.u).all())
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
print(*sorted(os.listdir(sys.argv[3])))
"""


def test_compressible_and_implicit_run_without_jax(tmp_path):
    """tests/data/case02_small3d.ini (Equations=internal) through the CLI,
    statistics at step 2, and the golden slice's case with
    TimeOrder=RungeKuttaDiffusion3 one semi-implicit step, where neither
    JAX nor tlab_tpu can be imported."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from test_golden import INI
    finally:
        sys.path.pop(0)
    comp = tmp_path / "case02.ini"
    text = (REPO / "tests" / "data" / "case02_small3d.ini").read_text()
    for old, new in (("Statistics=5", "Statistics=2"), ("Imax=128", "Imax=32"),
                     ("Jmax=64", "Jmax=32"), ("points_1=129", "points_1=33"),
                     ("points_1=64", "points_1=32")):
        text = text.replace(old, new)
    comp.write_text(text)
    smr = tmp_path / "smr91.ini"
    smr.write_text(INI.replace("TimeOrder=RungeKuttaExplicit3",
                               "TimeOrder=RungeKuttaDiffusion3"))
    out = tmp_path / "run"
    proc = _run(_SLICE_PROBE, str(comp), str(smr), str(out))
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split("\n")[-2].split()
    for want in ("flow.0.4", "flow.0.5", "flow.0.s1", "dns.out", "avg2",
                 "avg2s1"):
        assert want in names, names


# the rest of the compressible set where JAX and tlab_tpu cannot be
# imported: Case14 (AirWater, NSCBC outflow, the buffer) through the CLI,
# and case02 with a combustion mixture and Type=spatial one step
_AIRWATER_PROBE = """
import os, sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
import torch
from tlab_tpu_torch.config import load_case
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.tools import cli
sim = Simulation.from_case(sys.argv[1], dtype=torch.float64, device="cpu")
assert sim.comp["aw"] is not None and sim.comp["nscbc"].ymin == "outflow"
common = ["--ini", sys.argv[1], "--outdir", sys.argv[2], "--device", "cpu",
          "--x64"]
for command in ("inigrid", "ini"):
    assert cli.main([command, *common]) == 0
assert cli.main(["dns", *common, "--steps", "2"]) == 0
text = open(os.path.join(sys.argv[2], "dns.out")).read()
assert "NewtonRs" in text
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
print(len([r for r in text.splitlines() if not r.startswith("#")]))
"""


def test_airwater_nscbc_simulation_without_jax(tmp_path):
    """An AirWater NSCBC Simulation from tests/data/case14_small3d.ini,
    and its inigrid, ini and two dns steps through the CLI, where neither
    JAX nor tlab_tpu can be imported."""
    ini = tmp_path / "tlab.ini"
    ini.write_text((REPO / "tests" / "data" / "case14_small3d.ini")
                   .read_text())
    proc = _run(_AIRWATER_PROBE, str(ini), str(tmp_path / "run"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "3"


# the statistics slice where JAX and tlab_tpu cannot be imported: dns with
# the in-run pdfs, spectra and phase averages, then every post-processing
# command of the port's CLI on its restart
_STATS_PROBE = """
import os, sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
from tlab_tpu_torch.tools import cli
common = ["--ini", sys.argv[1], "--outdir", sys.argv[2], "--device", "cpu",
          "--x64"]
for command in ("inigrid", "ini", "dns", "averages", "pdfs", "spectra",
                "superlayer", "stats2nc"):
    extra = ["--files", "2"] if command not in ("inigrid", "ini",
                                                "dns") else []
    assert cli.main([command, *common, *extra]) == 0, command
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
print(" ".join(sorted(os.listdir(sys.argv[2]))))
"""


def test_statistics_run_without_jax(tmp_path):
    """inigrid, ini, dns (2 steps, [Statistics] pdfs/spectra, PhaseAvg) and
    averages, pdfs, spectra, superlayer, stats2nc of a 32x24x16 copy of
    tests/data/case01_small3d.ini where neither JAX nor tlab_tpu can be
    imported."""
    text = (REPO / "tests" / "data" / "case01_small3d.ini").read_text()
    for old, new in (("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
                     ("points_1=129", "points_1=33"),
                     ("points_1=64", "points_1=24"), ("End=10", "End=2"),
                     ("Restart=10", "Restart=2"),
                     ("Statistics=5", "Statistics=2"),
                     ("IteraLog=1", "IteraLog=1\nPhaseAvg=1"),
                     ("[BufferZone]", "[Statistics]\nPdfs=yes\n"
                      "Spectrums=yes\n\n[BufferZone]")):
        assert old in text
        text = text.replace(old, new)
    ini = tmp_path / "tlab.ini"
    ini.write_text(text)
    proc = _run(_STATS_PROBE, str(ini), str(tmp_path / "run"))
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split("\n")[-2].split()
    for want in ("avg2.nc", "phavg2.npz", "pdf2.p", "pdf2.s1", "xsp2.Euu",
                 "rsp2.E11", "sl2.npz"):
        assert want in names, names


# the I/O and particles slice where JAX and tlab_tpu cannot be imported:
# ini, inipart, dns with tracers, planes and towers, then planes2nc and
# tower2nc through the port's CLI; the restart engine built from
# native/tlabio.cpp
_PARTICLE_PROBE = """
import os, sys
for name in ("jax", "jaxlib", "tlab_tpu"):
    sys.modules[name] = None
from tlab_tpu_torch.tools import cli
from tlab_tpu_torch.io import fields_io
common = ["--ini", sys.argv[1], "--outdir", sys.argv[2], "--device", "cpu",
          "--x64"]
for command in ("ini", "inipart", "dns", "planes2nc", "tower2nc"):
    extra = ["--files", "2"] if command == "planes2nc" else []
    assert cli.main([command, *common, *extra]) == 0, command
assert fields_io._engine().__name__ == "_tlabio"
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "jaxlib", "tlab_tpu")]
assert not bad, bad
print(" ".join(sorted(os.listdir(sys.argv[2]))))
"""


def test_particles_planes_and_towers_run_without_jax(tmp_path):
    """ini, inipart, dns (2 steps: tracers with trajectories, planes and
    towers), planes2nc and tower2nc of a 32x24x16 copy of
    tests/data/case01_small3d.ini where neither JAX nor tlab_tpu can be
    imported."""
    text = (REPO / "tests" / "data" / "case01_small3d.ini").read_text()
    for old, new in (("Imax=128", "Imax=32"), ("Jmax=64", "Jmax=24"),
                     ("points_1=129", "points_1=33"),
                     ("points_1=64", "points_1=24"), ("End=10", "End=2"),
                     ("Restart=10", "Restart=2"),
                     ("Statistics=5", "Statistics=2"),
                     ("IteraLog=1", "IteraLog=1\nSavePlanes=2")):
        assert old in text
        text = text.replace(old, new)
    text += ("\n[Particles]\nType=Tracer\nNumber=100\nTrajNumber=4\n"
             "\n[SavePlanes]\nPlanesJ=3\n\n[SaveTowers]\nStride=8,2,8\n")
    ini = tmp_path / "tlab.ini"
    ini.write_text(text)
    proc = _run(_PARTICLE_PROBE, str(ini), str(tmp_path / "run"))
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split("\n")[-2].split()
    for want in ("part.0", "part.2", "trajectories.1-2.npz", "planesJ.2",
                 "planesJ.2.nc", "towers.nc", "tower.mean.000002-000002.1"):
        assert want in names, names


# dns on a 2x1 rank mesh through the port's command line; the ranks it
# spawns inherit PYTHONPATH, where a `jax`, `jaxlib` and `tlab_tpu` that
# raise on import stand first
_MESH_PROBE = """
import os, sys
from tlab_tpu_torch.tools import cli
common = ["--ini", sys.argv[1], "--outdir", sys.argv[2], "--device", "cpu",
          "--x64"]
assert cli.main(["ini", *common]) == 0
assert cli.main(["dns", *common, "--steps", "2", "--mesh", "2,1"]) == 0
print(*sorted(os.listdir(sys.argv[2])))
"""


def test_mesh_dns_runs_without_jax(tmp_path):
    """The mesh modules (parallel/, particles/parallel.py, io/sharded.py)
    and dns --mesh, in the launching process and in every spawned rank,
    where neither JAX nor tlab_tpu can be imported."""
    fake = tmp_path / "fake"
    for name in ("jax", "jaxlib", "tlab_tpu"):
        (fake / name).mkdir(parents=True)
        (fake / name / "__init__.py").write_text(
            "raise ImportError('the card machine has no JAX')\n")
    ini = tmp_path / "tlab.ini"
    ini.write_text((REPO / "tests" / "data" / "case01_small3d.ini")
                   .read_text().replace("Statistics=5", "Statistics=2"))
    out = tmp_path / "run"
    env = dict(__import__("os").environ, PYTHONPATH=f"{fake}:{REPO}")
    proc = subprocess.run([sys.executable, "-c", _MESH_PROBE, str(ini),
                           str(out)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split("\n")[-2].split()
    for want in ("dns.out", "tlab.log", "avg2", "avg2s1"):
        assert want in names, names
