"""The port's entry points run on the card unless the caller asks for the
CPU: every public function or method of tlab_tpu_torch whose `device`
parameter has a default has "cuda" there.  A required `device` (as in
convert.py) is fine: the caller then names it."""
import importlib
import inspect
import pkgutil

import pytest
import torch

import tlab_tpu_torch
from tlab_tpu_torch import grid as tgrid
from tlab_tpu_torch.fdm.plan import build_fdm_plan
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.ops import elliptic
from tlab_tpu_torch.ops import elliptic_factorize as fac
from tlab_tpu_torch.ops import filter as filt
from tlab_tpu_torch.runtime import make_sources

# the entry points known to take a default device; the walk must see them
KNOWN = ("tlab_tpu_torch.entry.build",
         "tlab_tpu_torch.runtime.Simulation.from_case",
         "tlab_tpu_torch.dycore.incompressible.build_device_plans",
         "tlab_tpu_torch.ops.elliptic_factorize.device_factorize_plan",
         "tlab_tpu_torch.ops.elliptic.device_elliptic_plan",
         "tlab_tpu_torch.ops.filter.build_filter_matrices",
         "tlab_tpu_torch.runtime.make_sources",
         "tlab_tpu_torch.ibm.build_ibm",
         "tlab_tpu_torch.ibm.build_ibm_spline",
         "tlab_tpu_torch.ibm.fill_from_dense",
         "tlab_tpu_torch.dycore.buffer.build_buffer",
         "tlab_tpu_torch.dycore.buffer.filter_sponge_amp",
         "tlab_tpu_torch.dycore.inflow.InflowBox.refs_at",
         "tlab_tpu_torch.particles.core.init_particles",
         "tlab_tpu_torch.particles.io.read_particles",
         "tlab_tpu_torch.tools.cloudstate.equilibrium_state",
         "tlab_tpu_torch.tools.cloudstate.mixing_diagram",
         "tlab_tpu_torch.tools.cloudstate.saturation_curve",
         "tlab_tpu_torch.tools.cloudstate.vapor_table",
         "tlab_tpu_torch.tools.cloudstate.buoyancy_reversal",
         "tlab_tpu_torch.parallel.mesh.make_mesh")


def _callables(module):
    """(qualified name, function) of the public functions defined in
    `module` and of the public methods of its classes."""
    for name, obj in vars(module).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                module.__name__:
            continue
        if inspect.isfunction(obj):
            yield f"{module.__name__}.{name}", obj
        elif inspect.isclass(obj):
            for mname, member in vars(obj).items():
                fn = getattr(member, "__func__", member)
                if inspect.isfunction(fn) and (not mname.startswith("_")
                                               or mname == "__init__"):
                    yield f"{module.__name__}.{name}.{mname}", fn


def _device_defaults() -> dict:
    """qualified name -> default of its `device` parameter, for every public
    callable of the package that gives that parameter a default."""
    found = {}
    for info in pkgutil.walk_packages(tlab_tpu_torch.__path__,
                                      "tlab_tpu_torch."):
        module = importlib.import_module(info.name)
        for qual, fn in _callables(module):
            par = inspect.signature(fn).parameters.get("device")
            if par is not None and par.default is not inspect.Parameter.empty:
                found[qual] = par.default
    return found


def test_every_default_device_is_the_card():
    wrong = {k: v for k, v in _device_defaults().items() if v != "cuda"}
    assert not wrong, wrong


@pytest.mark.parametrize("qual", KNOWN)
def test_walk_sees_the_entry_points(qual):
    assert _device_defaults().get(qual) == "cuda"


def test_factorize_plan_raises_without_a_card():
    """device_factorize_plan with no device named goes to the card, and
    where there is none it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    plan = fac.build_factorize_plan(
        build_fdm_plan(tgrid.uniform_grid(16, 12, 8, 2.0, 1.0, 1.5)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fac.device_factorize_plan(plan)
    dev = fac.device_factorize_plan(plan, torch.float64, "cpu")
    assert all(t.device.type == "cpu" for t in dev.values()
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("what", ["elliptic", "filter", "sources"])
def test_new_plans_raise_without_a_card(what):
    """The direct eigen plan, the filter matrices and the source hook with
    no device named go to the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    grid = tgrid.uniform_grid(16, 12, 8, 2.0, 1.0, 1.5)
    fdm = build_fdm_plan(grid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if what == "elliptic":
            elliptic.device_elliptic_plan(elliptic.build_elliptic_plan(fdm))
        elif what == "filter":
            filt.build_filter_matrices(fdm, filt.FilterSpec(type="compact"))
        else:
            make_sources(load_case(Ini(
                text="[Gravity]\nType=Linear\nVector=0,-1,0\n"
                     "Parameters=1.0\n")), grid)
    dev = elliptic.device_elliptic_plan(elliptic.build_elliptic_plan(fdm),
                                        torch.float64, "cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.float64
               for t in dev.values() if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("what", ["ibm", "fills", "buffer", "sponge",
                                  "inflow"])
def test_boundary_tables_raise_without_a_card(what):
    """The immersed boundary's mask and fills, the buffer's tables, the
    sponge's amplitude and the inflow planes with no device named go to
    the card, and raise where there is none; on the CPU where asked."""
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    import numpy as np
    from tlab_tpu_torch import ibm
    from tlab_tpu_torch.dycore import buffer, inflow
    grid = tgrid.uniform_grid(16, 12, 8, 2.0, 1.0, 1.5)
    eps = ibm.geometry_xbars(grid, 2, 3, 2)
    y = grid.y.nodes
    spec = buffer.BufferSpec(type="relaxation", points_jmax=4)
    box = inflow.InflowBox(fields={"u": np.ones((4, 12))}, u_convect=1.0,
                           lx=1.0)
    call = {
        "ibm": lambda **kw: ibm.build_ibm(eps, **kw)["eps"],
        "fills": lambda **kw: ibm.build_ibm_spline(eps, grid,
                                                   **kw)["z"]["index"],
        "buffer": lambda **kw: buffer.build_buffer(
            y, spec, {"u": y}, **kw)["tau"],
        "sponge": lambda **kw: buffer.filter_sponge_amp(grid.x.nodes, 4, 4,
                                                        **kw),
        "inflow": lambda **kw: box.refs_at(0.5, **kw)["u"]}[what]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert call(device="cpu").device.type == "cpu"


def test_mesh_device_raises_without_a_card():
    """make_mesh's default device is the card: a rank's device resolves to
    it, and where there is none that raises rather than run on the CPU."""
    from tlab_tpu_torch.parallel import mesh as pmesh
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.rank_device("cuda", 0)
    assert pmesh.rank_device("cpu", 3) == torch.device("cpu")
    assert pmesh.backend_rule(4, "cpu") == "gloo"
