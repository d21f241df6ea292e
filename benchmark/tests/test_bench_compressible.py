"""The compressible set on the CPU: reference/compressible.py against the
port's float64 compressible step, a small run of case02.loop judged by its
own limits, the faults its comparison must catch, the roofline's count of
its right-hand side, and the refusal of statistics it cannot judge."""
import copy

import numpy as np
import pytest
import torch

from harness import cell as cellmod
from harness import fields, sets, spec
from reference import ops
from reference.compressible import Model

SHAPE = (32, 16, 16)
SEED = 2 ** 31 + 4321
CELL = "case02.loop"


def quiet(msg):
    pass


def _case(shape=SHAPE):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "case02.json")
    return cfg, spec.resized(cfg["ini"], shape)


@pytest.mark.parametrize("steps", [1, 3])
def test_a_step_is_the_ports(steps):
    """The dns loop's step function from the benchmark's own initial
    fields in float64: each step's change and its diagnostics against the
    reference's from the same state and dt."""
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.runtime import Simulation
    from tlab_tpu_torch.tools import dns
    cfg, ini = _case()
    sim = Simulation.from_case(load_case(Ini(text=spec.ini_text(ini))),
                               dtype=torch.float64, device="cpu")
    eqs = sets.of(sim)
    assert eqs is sets.Compressible and eqs is sets.of_case(ini)
    step, diagnostics = dns.make_step_functions(sim)
    q = fields.initial_stack(cfg, ini, SEED, "cpu", torch.float64)
    assert q.shape[0] == eqs.n_fields(sim) == 6
    model = Model(ini, "cpu")
    assert np.allclose(diagnostics(eqs.unstack(q)).tolist(),
                       model.diagnostics(q)[0], rtol=1e-12, atol=0.0)
    dt = eqs.next_dt(sim, diagnostics(eqs.unstack(q)).tolist())
    for _ in range(steps):
        new, _, diag = step(eqs.unstack(q), dt)
        got = eqs.stack(new)
        ref, _ = model.step(q, dt)
        size = (ref - q).flatten(1).abs().max(dim=1).values
        gap = (got - ref).flatten(1).abs().max(dim=1).values / size
        assert float(gap.max()) <= 1e-12, gap
        d, _ = model.diagnostics(got)
        assert np.allclose(diag.tolist(), d, rtol=1e-12, atol=0.0)
        q = got
        dt = eqs.next_dt(sim, diag.tolist())


def test_the_initial_fields():
    """rho = 1, T = 1 (p = 1/(gamma M^2)), v = 0 on the walls, the same
    fields from the same seed."""
    cfg, ini = _case()
    q = fields.initial_stack(cfg, ini, SEED, "cpu", torch.float64)
    model = Model(ini, "cpu")
    assert torch.equal(q[0], torch.ones_like(q[0]))
    assert torch.allclose(model.temperature(q), torch.ones_like(q[0]))
    assert float(q[2][:, [0, -1], :].abs().max()) == 0.0
    assert 0.0 <= float(q[5].min()) and float(q[5].max()) <= 1.0
    assert torch.equal(q, fields.initial_stack(cfg, ini, SEED, "cpu",
                                               torch.float64))


def test_a_small_run_is_correct_by_its_own_limits():
    c = spec.find_cell(CELL)
    r = cellmod.run(c, SEED, 1.0, False, device="cpu", shape=SHAPE,
                    log=quiet)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(c.limits)
    assert r["correct"], r["checks"]


def _during(module, attr, make):
    """A patch: the step with tlab_tpu_torch.dycore.<module>.<attr>
    replaced by make(original) while it runs."""
    import importlib
    mod = importlib.import_module(f"tlab_tpu_torch.dycore.{module}")

    def patch(step):
        def bad(state, dt, extra=None):
            orig = getattr(mod, attr)
            setattr(mod, attr, make(orig))
            try:
                return step(state, dt)
            finally:
                setattr(mod, attr, orig)
        return bad
    return patch


def _no_conduction(orig):
    return lambda *a, **k: 0.0


def _no_p_divu(orig):
    from tlab_tpu_torch.dycore import compressible as cm

    def rhs(P, U, gamma, mach, *a, **k):
        dh = orig(P, U, gamma, mach, *a, **k)
        u, v, w, _, p = cm.primitive_internal(P, U, gamma, mach)
        return dh._replace(rhoE=dh.rhoE + p * cm._div(P, u, v, w))
    return rhs


def _in_tf32(orig):
    """A dense derivative product with its operands in TF32."""
    def product(plan, u, axis):
        return orig(ops.tf32(plan), ops.tf32(u), axis)
    return product


def _both(*patches):
    def patch(step):
        for p in patches:
            step = p(step)
        return step
    return patch


@pytest.mark.parametrize("fault", [
    _during("compressible", "_conduction_coef", _no_conduction),
    _during("compressible", "rhs_compressible_internal", _no_p_divu),
    _both(_during("incompressible", "der1", _in_tf32),
          _during("incompressible", "der12", _in_tf32))],
    ids=["conduction dropped", "p div u dropped", "products in TF32"])
def test_a_broken_rhs_is_not_correct(fault):
    c = spec.find_cell(CELL)
    r = cellmod.run(c, SEED, 1.0, False, device="cpu", shape=SHAPE,
                    log=quiet, patch=fault)
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]


def test_roofline_comp_rhs_hand_count():
    b = spec.roofline("comp_rhs").bound((8, 6, 4), 6)
    n = 8 * 6 * 4
    # one scalar: 36 first and 15 second derivatives, 10 and 15 operations
    # a point each; 86 + 17 of pointwise algebra
    assert (b["d1"], b["d2"]) == (36, 15)
    assert b["ops"] == (36 * 10 + 15 * 15 + 86 + 17) * n
    assert b["bytes"] == 2 * 6 * n * 4
    assert b["seconds"] == pytest.approx(max(b["ops"] / 165e12,
                                             b["bytes"] / 3.35e12))
    # no scalar: no scalar fluxes, gradients or Laplacians, no grad rho
    b0 = spec.roofline("comp_rhs").bound((8, 6, 4), 5)
    assert (b0["d1"], b0["d2"]) == (27, 12)
    # a plane: two directions
    assert spec.roofline("comp_rhs").bound((8, 6, 1), 6)["d1"] == 24
    big = spec.roofline("comp_rhs").bound((512, 256, 256), 6, 4)
    assert big["by"] == "bytes"
    assert 1e3 * big["seconds"] == pytest.approx(0.4808, abs=1e-4)


def test_a_compressible_cell_with_statistics_is_refused():
    c = copy.deepcopy(spec.find_cell(CELL))
    c.traffic = spec.load_json(spec.BENCH_DIR / "traffic" / "stats.json")
    with pytest.raises(ValueError, match="Favre"):
        cellmod.run(c, SEED, 0.5, False, device="cpu", shape=SHAPE,
                    log=quiet)


def test_the_sets_of_each_configuration():
    for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]:
        c = spec.find_cell(w["name"])
        want = sets.Compressible if w["config"] == "case02" \
            else sets.Incompressible
        assert sets.of_case(c.config["ini"]) is want
    assert sets.names(sets.Compressible, 6) == (
        "rho", "rhou", "rhov", "rhow", "rhoe", "s1")
    assert sets.names(sets.Incompressible, 5) == ("u", "v", "w", "s1",
                                                  "s2")
