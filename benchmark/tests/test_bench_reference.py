"""The plain reference against the port at a tiny size on the CPU, in
float64, where both compute the same discrete equations and agree to
round-off; and the control, the reference one precision lower, apart from
the program at the same size."""
import numpy as np
import pytest
import torch

from harness import cell as cellmod
from harness import fields, spec
from reference import averages, ops
from reference.poisson import Poisson
from reference.step import Model

SHAPE = (16, 24, 8)
SEED = 2 ** 31 + 99


def _case(name, shape=SHAPE):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
    return cfg, spec.resized(cfg["ini"], shape)


def _sim(ini):
    from tlab_tpu_torch.config import Ini, load_case
    from tlab_tpu_torch.runtime import Simulation
    return Simulation.from_case(load_case(Ini(text=spec.ini_text(ini))),
                                dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["shear3d", "cloudtop"])
def test_operators_are_the_ports(name):
    from tlab_tpu_torch.constants import BC
    _, ini = _case(name)
    sim = _sim(ini)
    model = Model(ini, "cpu")
    for a, p in zip(model.axes, (sim.fdm.x, sim.fdm.y, sim.fdm.z)):
        assert np.array_equal(a.nodes, p.nodes)
        assert np.abs(a.d1 - p.d1[BC.DD]).max() <= 1e-12 * np.abs(a.d1).max()
        assert np.abs(a.d2 - p.d2[BC.DD]).max() <= 1e-12 * np.abs(a.d2).max()


def test_poisson_is_the_ports():
    from tlab_tpu_torch.ops import elliptic_factorize as fac
    _, ini = _case("shear3d")
    sim = _sim(ini)
    model = Model(ini, "cpu")
    g = torch.Generator().manual_seed(3)
    f = torch.randn(SHAPE, generator=g, dtype=torch.float64)
    bb, bt = (torch.randn(SHAPE[0], SHAPE[2], generator=g,
                          dtype=torch.float64) for _ in range(2))
    p1, d1 = fac.poisson_factorize(sim.P["ell_fac"], f, bcs_b=bb, bcs_t=bt)
    p2, d2 = model.poisson.solve(f, bb, bt)
    assert float((p1 - p2).abs().max()) <= 1e-12 * float(p1.abs().max())
    assert float((d1 - d2).abs().max()) <= 1e-12 * float(d1.abs().max())


def test_background_is_the_ports():
    _, ini = _case("cloudtop")
    sim = _sim(ini)
    model = Model(ini, "cpu")
    for k in ("p", "rho", "ep"):
        a = sim.anelastic["bg"][k]
        b = model.bg[k][0, :, 0]
        assert float((a - b).abs().max()) <= 1e-13 * float(a.abs().max())


@pytest.mark.parametrize("name,tol", [("shear3d", 1e-12),
                                      ("cloudtop", 1e-7)])
def test_a_step_is_the_ports(name, tol):
    """One step of the dns loop's step function from the benchmark's own
    initial fields: the port's float64 change against the reference's.
    (The cloud top's saturation adjustment switches on a comparison, so
    round-off in a point at the saturation line moves its buoyancy.)"""
    from tlab_tpu_torch.dycore import incompressible as dyn
    from tlab_tpu_torch.dycore.state import stack, unstack
    from tlab_tpu_torch.tools import dns
    cfg, ini = _case(name)
    sim = _sim(ini)
    step, diagnostics = dns.make_step_functions(sim)
    q = fields.initial_stack(cfg, ini, SEED, "cpu", torch.float64)
    dt = dyn.next_dt(sim.P, diagnostics(unstack(q)).tolist()[0],
                     sim.case.time_cfl, sim.case.time_cfl_diffusive)
    for _ in range(3):
        new, _, diag = step(unstack(q), dt)
        model = Model(ini, "cpu")
        ref, _ = model.step(q, dt)
        got = stack(new)
        d_ref = ref - q
        size = d_ref.flatten(1).abs().max(dim=1).values
        size[:3] = size[:3].max()
        gap = (got - ref).flatten(1).abs().max(dim=1).values / size
        assert float(gap.max()) <= tol, gap
        d, _ = model.diagnostics(got)
        assert np.allclose(diag.tolist(), d, rtol=1e-12, atol=1e-14)
        q = got


def test_the_averages_are_the_ports():
    from tlab_tpu_torch.dycore.state import unstack
    from tlab_tpu_torch.stats import averages as pavg
    cfg, ini = _case("shear3d")
    sim = _sim(ini)
    q = fields.initial_stack(cfg, ini, SEED, "cpu", torch.float64)
    p = torch.randn(SHAPE, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    flow, scal = pavg.stats_tables(sim, unstack(q), p)
    rflow, rscal = averages.tables(Model(ini, "cpu"), q, p)
    tabs = [{k: torch.as_tensor(v) for k, v in t.items()}
            for t in [flow] + scal]
    for t, r in zip(tabs, [rflow] + rscal):
        name, gap = averages.gap(t, r)
        assert gap <= 1e-13, name


def test_tf32_rounding():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0],
                     dtype=torch.float32)
    assert ops.tf32(a).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                    -3.0]


@pytest.mark.parametrize("name", ["shear3d.loop", "cloudtop.loop",
                                  "shear3d.stats", "case02.loop"])
def test_the_control_reads_far_above_the_program(name):
    """The control (the reference in float32 with TF32 products in the
    program's place) at a small size on the CPU: its worst number reads at
    least ten times the program's, on the numbers the cell's limits hold."""
    c = spec.find_cell(name)
    shape = (32, 48, 16)
    sec = 2.0 if name.endswith(".stats") else 0.5     # >= 10 steps, finite
    prog = cellmod.run(c, SEED, sec, False, device="cpu", shape=shape,
                       log=lambda m: None)
    ctl = cellmod.run(c, SEED, sec, False, device="cpu", shape=shape,
                      log=lambda m: None, control="tf32")
    ratio = max(ctl["checks"][k]["value"] / prog["checks"][k]["value"]
                for k in prog["checks"] if prog["checks"][k]["value"] > 0)
    assert ratio >= 10.0
    assert not ctl["correct"]


def test_poisson_solves_its_problem():
    """The reference's own solve, held to the problem it solves: after the
    projection the D1-divergence of a noisy field vanishes to round-off
    at every interior plane (the wall planes carry the Neumann data)."""
    _, ini = _case("shear3d", (16, 32, 8))
    model = Model(ini, "cpu")
    g = torch.Generator().manual_seed(11)
    u = torch.randn((3, 16, 32, 8), generator=g, dtype=torch.float64)
    u[1][:, 0, :] = 0.0
    u[1][:, -1, :] = 0.0
    div = sum(model.d1_along(u[i], i) for i in range(3))
    z = torch.zeros((16, 8), dtype=torch.float64)
    p, dpdy = model.poisson.solve(div, z, z)
    un = u.clone()
    un[0] -= model.d1_along(p, 0)
    un[1] -= dpdy
    un[2] -= model.d1_along(p, 2)
    div2 = sum(model.d1_along(un[i], i) for i in range(3))
    assert float(div2[:, 1:-1].abs().max()) <= 1e-12 * float(div.abs().max())
    assert isinstance(model.poisson, Poisson)


def test_the_single_precision_solve_solves_its_problem():
    """Poisson.single(), the witnesses' float32 solve: the same method in
    complex64, which leaves the projected divergence at float32's
    round-off, and the float64 solve's tables untouched."""
    _, ini = _case("shear3d", (16, 32, 8))
    model = Model(ini, "cpu")
    single = model.poisson.single()
    assert model.poisson.Vmin.dtype == torch.complex128
    assert single.Vmin.dtype == torch.complex64
    g = torch.Generator().manual_seed(12)
    u = torch.randn((3, 16, 32, 8), generator=g, dtype=torch.float64)
    u[1][:, 0, :] = 0.0
    u[1][:, -1, :] = 0.0
    div = sum(model.d1_along(u[i], i) for i in range(3))
    z = torch.zeros((16, 8), dtype=torch.float32)
    p, dpdy = single.solve(div.to(torch.float32), z, z)
    assert p.dtype == torch.float32
    un = u.clone()
    un[0] -= model.d1_along(p.double(), 0)
    un[1] -= dpdy.double()
    un[2] -= model.d1_along(p.double(), 2)
    div2 = sum(model.d1_along(un[i], i) for i in range(3))
    gap = float(div2[:, 1:-1].abs().max()) / float(div.abs().max())
    assert 1e-9 < gap <= 1e-4


@pytest.mark.parametrize("kind", ["fp32", "bg32"])
def test_the_witnesses_read_far_below_the_control(kind):
    """The witnesses (the reference wholly in float32, or in float64 on a
    float32 background) judged by the same numbers: each reads under a
    tenth of what the control reads on the same number."""
    c = spec.find_cell("cloudtop.loop")
    shape = (32, 48, 16)
    ctl = cellmod.run(c, SEED, 0.5, False, device="cpu", shape=shape,
                      log=lambda m: None, control="tf32")
    wit = cellmod.run(c, SEED, 0.5, False, device="cpu", shape=shape,
                      log=lambda m: None, control=kind)
    for k, v in wit["checks"].items():
        assert v["value"] <= 0.1 * ctl["checks"][k]["value"], k


def test_the_solve_in_blocks_of_modes_is_the_whole_solve(monkeypatch):
    """The solve a block of kx rows at a time, which keeps a grid of a
    card's size inside the card, gives the one-block solve's numbers."""
    from reference import poisson
    _, ini = _case("shear3d", (32, 24, 16))
    g = torch.Generator().manual_seed(13)
    f = torch.randn((32, 24, 16), generator=g, dtype=torch.float64)
    bb, bt = (torch.randn((32, 16), generator=g, dtype=torch.float64)
              for _ in range(2))
    monkeypatch.setattr(poisson, "CHUNKS", 1)
    whole = Model(ini, "cpu").poisson
    assert len(whole._chunks()) == 1
    p1, d1 = whole.solve(f, bb, bt)
    monkeypatch.setattr(poisson, "CHUNKS", 8)
    blocks = Model(ini, "cpu").poisson
    assert len(blocks._chunks()) == 6          # 17 rows in blocks of 3
    p2, d2 = blocks.solve(f, bb, bt)
    for a, b in ((p1, p2), (d1, d2)):
        assert float((a - b).abs().max()) <= 1e-14 * float(a.abs().max())
    for name in ("em", "v1", "u1", "sp", "ep", "du1_n", "dsp_n", "dep_n"):
        a, b = getattr(whole, name), getattr(blocks, name)
        assert float((a - b).abs().max()) <= 1e-14 * float(a.abs().max())


def _judged(name):
    """A cell's judge inputs at SHAPE: the warm step and a last step of
    the reference itself, the program's side perturbed."""
    c = spec.find_cell(name)
    ini = spec.resized(c.config["ini"], SHAPE)
    q0 = fields.initial_stack(c.config, ini, SEED, "cpu", torch.float32)
    model = Model(ini, "cpu")
    (cfl, *_), _ = model.diagnostics(q0)
    dt = 1.0 / cfl
    g = torch.Generator().manual_seed(17)
    new0 = model.step(q0, dt)[0].float()
    new0 += 1e-6 * torch.randn(new0.shape, generator=g)
    new1 = model.step(new0, dt)[0].float()
    start = {"new": new0, "dt": dt, "diag": model.diagnostics(new0)[0]}
    last = {"old": new0, "new": new1, "dt": dt,
            "diag": model.diagnostics(new1)[0]}
    return c, ini, q0, start, last


def test_the_default_reference_gives_todays_numbers():
    """A configuration without a "reference" key is judged by
    reference/step.py, the one module there was: the same numbers as
    naming it, and as check.step_gaps with reference.step.Model."""
    import copy

    from harness import check
    c, ini, q0, start, last = _judged("shear3d.loop")
    assert "reference" not in c.config
    assert cellmod.reference_model(c) is Model
    default = cellmod.judge(c, ini, "cpu", q0, start, last, None, "", 0,
                            lambda m: None)
    named = copy.deepcopy(c)
    named.config["reference"] = "step"
    assert cellmod.judge(named, ini, "cpu", q0, start, last, None, "", 0,
                         lambda m: None) == default
    model = Model(ini, "cpu")
    today = check.step_gaps(model, "start", q0, start["new"], start["dt"],
                            start["diag"])
    today.update(check.step_gaps(model, "last", last["old"], last["new"],
                                 last["dt"], last["diag"]))
    assert today == default
    assert 0.0 < default["start_u"] < 1e-3


def test_a_configuration_names_its_reference(monkeypatch):
    """"reference": "<name>" takes reference/<name>.py's Model, so that a
    new configuration brings its reference as a new file."""
    import sys
    import types
    calls = []

    class Other(Model):
        def __init__(self, *a, **k):
            calls.append(a[0])
            super().__init__(*a, **k)

    mod = types.ModuleType("reference.other")
    mod.Model = Other
    monkeypatch.setitem(sys.modules, "reference.other", mod)
    c, ini, q0, start, last = _judged("shear3d.loop")
    c.config = dict(c.config, reference="other")
    assert cellmod.reference_model(c) is Other
    out = cellmod.judge(c, ini, "cpu", q0, start, last, None, "", 0,
                        lambda m: None)
    assert calls == [ini] and set(out) >= {"start_u", "last_diag"}
