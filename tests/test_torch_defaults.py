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
from tlab_tpu_torch.ops import elliptic_factorize as fac

# the entry points known to take a default device; the walk must see them
KNOWN = ("tlab_tpu_torch.entry.build",
         "tlab_tpu_torch.runtime.Simulation.from_case",
         "tlab_tpu_torch.dycore.incompressible.build_device_plans",
         "tlab_tpu_torch.ops.elliptic_factorize.device_factorize_plan")


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
