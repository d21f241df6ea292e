"""The statistics of one snapshot (tlab_tpu_torch/stats/{pdfs,spectra,
superlayer,phaseavg}.py, particles/core.py's locator) against tlab_tpu's,
float64 on the CPU, on the seeded state of tests/test_torch_pressure.py.

Limits: the device PDF table equals the host reference_formats table bit
for bit; the analysis-mode fields, the spectra and the superlayer samples
to 1e-10 of their max; the files the port writes from its fields equal
tlab_tpu's writers' files from the same fields byte for byte; the phase
sums to 1e-12.  tlab_tpu's own device PDF table re-derives the trimmed
range in another order than its host table, which moves the sample at a
trimmed edge by one bin in about half the fields (ROADMAP C 24): against
it the counts agree to one sample a row."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tlab_tpu.config import Ini as JIni, load_case as jload_case
from tlab_tpu.dycore.pressure import pressure_boussinesq as jpressure
from tlab_tpu.dycore.state import State as JState
from tlab_tpu.io import reference_formats as jrf
from tlab_tpu.runtime import Simulation as JSimulation
from tlab_tpu.stats import pdfs as jpdfs
from tlab_tpu.stats import phaseavg as jphase
from tlab_tpu.stats import spectra as jspec
from tlab_tpu.stats import superlayer as jsl
from tlab_tpu.tools import dns as jdns
from tlab_tpu_torch.config import Ini, load_case
from tlab_tpu_torch.convert import state_from_numpy
from tlab_tpu_torch.io import reference_formats as rf
from tlab_tpu_torch.runtime import Simulation
from tlab_tpu_torch.stats import averages as tavg
from tlab_tpu_torch.stats import pdfs as tpdfs
from tlab_tpu_torch.stats import phaseavg as tphase
from tlab_tpu_torch.stats import spectra as tspec
from tlab_tpu_torch.stats import superlayer as tsl
from tlab_tpu_torch.tools import dns as tdns
from test_torch_pressure import INI, seeded_fields

F64 = torch.float64

torch.set_num_threads(2)

STATS = "[Statistics]\nPdfs=yes\nIntermittency=yes\nSpectrums=yes\n" \
    "Correlations=yes\nGateLevel=0.45\n"


@pytest.fixture(scope="module")
def pair():
    jsim = JSimulation.from_case(jload_case(JIni(text=INI + STATS)))
    tsim = Simulation.from_case(load_case(Ini(text=INI + STATS)),
                                dtype=F64, device="cpu")
    u, v, w, s = seeded_fields(tsim.grid.shape, tsim.grid.y.nodes)
    js = JState(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                s=jnp.asarray(s))
    return jsim, js, tsim, state_from_numpy(u, v, w, s, "cpu", F64)


def _close(got, ref, what, tol=1e-10):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref)), what


def _table_field(kind):
    rng = np.random.default_rng(11)
    f = rng.standard_normal((32, 24, 16))
    if kind == "ties":
        f = np.round(f * 4) / 4              # many exact bin-edge ties
    elif kind == "constant":
        f[:, 2, :] = 3.25                    # a constant plane
    elif kind == "clipped":
        # a shear-layer scalar: free streams exactly at 0 and 1
        y = np.linspace(-1, 1, 24)[None, :, None]
        f = np.clip(0.5 + 0.6 * np.tanh(4 * y) + 0.05 * f, 0.0, 1.0)
    elif kind == "float32":
        f = f.astype(np.float32)
    return f


KINDS = ["normal", "ties", "constant", "clipped", "float32"]


@pytest.mark.parametrize("kind", KINDS)
def test_device_table_equals_host_table(kind):
    f = _table_field(kind)
    got = tpdfs.pdf1v_plane_table_device(torch.as_tensor(f), 32)
    assert got.dtype == F64 and got.shape == (25, 34)
    assert np.array_equal(got.numpy(), rf.pdf1v_plane_table(f, 32, ibc=2))
    nx, ny, nz = f.shape
    assert np.all(got[:-1, :32].sum(1).numpy() <= nx * nz)
    assert got[-1, :32].sum() <= f.size


@pytest.mark.parametrize("kind", KINDS[:4])
def test_device_table_against_jax(kind):
    """tlab_tpu's device table on the same field: bin centres to 1e-12,
    the counts of a row equal but for one sample at a trimmed edge."""
    f = _table_field(kind)
    got = tpdfs.pdf1v_plane_table_device(torch.as_tensor(f), 32).numpy()
    ref = np.asarray(jpdfs.pdf1v_plane_table_device(jnp.asarray(f), 32))
    _close(got[:, 32:], ref[:, 32:], "centres", 1e-12)
    moved = np.abs(got[:, :32] - ref[:, :32])
    assert np.all(moved.sum(1) <= 1)
    assert np.all(moved[:, 1:-1] == 0)


@pytest.mark.parametrize("gated", [False, True])
def test_pdf_per_plane_matches_jax(pair, gated):
    jsim, js, tsim, ts = pair
    gt = ts.s[0] > 0.5 if gated else None
    gj = js.s[0] > 0.5 if gated else None
    c, e = tpdfs.pdf_per_plane(ts.u, 16, gate=gt)
    cj, ej = jpdfs.pdf_per_plane(js.u, 16, gate=gj)
    assert np.array_equal(c.numpy(), np.asarray(cj))
    _close(e, ej, "edges", 1e-14)


MODES = [1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15]


@pytest.mark.parametrize("mode", MODES)
def test_mode_fields_match_jax(pair, mode):
    """mode_fields of each ParamPdfs mode: the same tags, every field to
    1e-10 of its max (the pressure the one of tlab_tpu, mode 1)."""
    jsim, js, tsim, ts = pair
    pj = jpressure(jsim.P, js)
    ref_s, ref_j = jpdfs.mode_fields(jsim, js, pj, mode)
    got_s, got_j = tpdfs.mode_fields(tsim, ts, torch.as_tensor(
        np.asarray(pj)) if mode == 1 else None, mode)
    assert [t for t, _ in got_s] == [t for t, _ in ref_s]
    assert [t for t, *_ in got_j] == [t for t, *_ in ref_j]
    for (tag, a), (_, b) in zip(got_s, ref_s):
        _close(a, b, tag)
    for (tag, a, b), (_, c, d) in zip(got_j, ref_j):
        _close(a, c, tag)
        _close(b, d, tag)


@pytest.mark.parametrize("mode, gate", [(1, 0.0), (1, 0.5), (5, 0.0),
                                        (9, 0.0), (15, 0.0)])
def test_pdf_files_match_jax(pair, tmp_path, mode, gate):
    """run_pdf_mode's files: mode 1 from the same fields through both
    packages' run_pdf_mode; the other modes the port's files against
    tlab_tpu's writers fed with the port's fields (their fields are held
    to tlab_tpu's above).  Byte for byte."""
    jsim, js, tsim, ts = pair
    pj = jpressure(jsim.P, js)
    pt = torch.as_tensor(np.asarray(pj))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tpdfs.run_pdf_mode(tsim, ts, pt, str(tmp_path / "t"), 3, 0.25,
                       opt_main=mode, nbins=(16, 12), gate_level=gate)
    if mode == 1:
        jpdfs.run_pdf_mode(jsim, js, pj, str(tmp_path / "j"), 3, 0.25,
                           opt_main=mode, nbins=(16, 12), gate_level=gate)
    else:
        # tlab_tpu's writers on the port's fields
        singles, joints = tpdfs.mode_fields(tsim, ts, pt, mode)
        y = tsim.grid.y.nodes
        for tag, a in singles:
            jpdfs._pdf1v_out(str(tmp_path / "j"), 3, 0.25, y, tag,
                             a.numpy(), 16)
        for tag, a, b in joints:
            jpdfs._pdf2v_out(str(tmp_path / "j"), 3, 0.25, y, tag,
                             a.numpy(), b.numpy(), (16, 12))
        _cavg_files(tsim, ts, pt, singles, mode, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


def _cavg_files(sim, st, p, singles, mode, out):
    """The conditional-average files of modes 9 and 15 by tlab_tpu's table
    functions, from the port's fields."""
    from tlab_tpu_torch import mappings as mp
    from tlab_tpu_torch.dycore import incompressible as dyn
    y = sim.grid.y.nodes
    if mode == 9:
        gigi = mp.gradient_magnitude2(sim.P, st.s[0]).numpy()
        for fname, fld in (("cavgGiGi", gigi),
                           ("cavgLnGiGi", np.log(gigi + 1e-300))):
            jrf.write_pdf_file(out, f"{fname}3.s", 0.25, y,
                               jrf.cavg1v_plane_table(st.s[0].numpy(), fld,
                                                      16, ibc=1), 16)
    elif mode == 15:
        b = dict(singles)["b"]
        fields = {"B": b, "Bii": mp.laplacian(sim.P, b), "U": st.u,
                  "W": st.w, "Vii": mp.laplacian(sim.P, st.v), "P": p,
                  "Py": dyn._d1(sim.P, "y", 1, p)}
        for fname, fld in fields.items():
            fld = fld.numpy()
            for tag, cond in (("b", b.numpy()), ("v", st.v.numpy())):
                jrf.write_pdf_file(out, f"cavg{fname}3.{tag}", 0.25, y,
                                   jrf.cavg1v_plane_table(cond, fld, 16,
                                                          ibc=1), 16)
            jrf.write_pdf_file(out, f"cavg{fname}3.bv", 0.25, y,
                               jrf.cavg2v_table(b.numpy(), st.v.numpy(),
                                                fld, (16, 12)), [16, 12])


SPECTRA = [(n, c) for n in ("spectrum_x", "spectrum_z", "correlation_x",
                             "correlation_z", "spectrum_2d")
           for c in (False, True)] + [("cross_phase_x", True),
                                      ("radial_spectrum", False)]


@pytest.mark.parametrize("name, cross", SPECTRA)
def test_spectra_match_jax(pair, name, cross):
    jsim, js, tsim, ts = pair
    if name == "radial_spectrum":
        args = (tsim.grid.x.scale, tsim.grid.z.scale)
        got = [tspec.radial_spectrum(ts.u, *args)]
        ref = [jspec.radial_spectrum(js.u, *args)]
    else:
        kw = {"y_blocks": 3} if name == "spectrum_2d" else {}
        tb, jb = (ts.s[0], js.s[0]) if cross else (None, None)
        targs = (ts.u, tb) if name != "cross_phase_x" else (ts.u, ts.v)
        jargs = (js.u, jb) if name != "cross_phase_x" else (js.u, js.v)
        got = getattr(tspec, name)(*targs, **kw)
        ref = getattr(jspec, name)(*jargs, **kw)
        got, ref = (got, ref) if name == "cross_phase_x" else ([got], [ref])
    for k, (a, b) in enumerate(zip(got, ref)):
        if name == "cross_phase_x" and k == 1:
            # the phase: where the power is round-off, so is the angle
            keep = np.asarray(ref[0]) > 1e-10 * np.max(np.asarray(ref[0]))
            a, b = np.asarray(a)[keep], np.asarray(b)[keep]
        _close(a, b, f"{name}[{k}]")


def test_parseval():
    """Each plane's x and z spectra of the fluctuation sum to the plane
    variance (a wrong normalisation or fold reads a factor of 2 or more).
    Even lengths, as the reference's grids: with an odd one the fold of
    both packages leaves the last wavenumber single."""
    u = torch.as_tensor(np.random.default_rng(8).standard_normal((16, 5,
                                                                   12)))
    a = u - torch.mean(u, dim=(0, 2), keepdim=True)
    var = torch.mean(a * a, dim=(0, 2))
    for e in (tspec.spectrum_x(a), tspec.spectrum_z(a)):
        assert float(torch.amax(torch.abs(e.sum(0) - var))) <= \
            1e-12 * float(torch.amax(var))


def test_inrun_pdfs_spectra_match_jax(pair, tmp_path):
    """[Statistics] Pdfs/Intermittency/Spectrums/Correlations of one state
    through both packages' writer: the same files; the spectra byte
    for byte, the intermittency to tlab_tpu's float32 rounding; each pdf file equal to the host table's
    file of the same field byte for byte, and to tlab_tpu's device table's
    but for one sample a row at a trimmed edge."""
    jsim, js, tsim, ts = pair
    for d in ("t", "j", "h"):
        (tmp_path / d).mkdir()
    tdns._inrun_pdfs_spectra(tsim, ts, str(tmp_path / "t"), 3, 0.25)
    jdns._inrun_pdfs_spectra(jsim, js, str(tmp_path / "j"), 3, 0.25)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert len(names) == 4 + 1 + 4 * 4
    fields = {"u": ts.u, "v": ts.v, "w": ts.w, "s1": ts.s[0]}
    for n in names:
        got = (tmp_path / "t" / n).read_bytes()
        if n.startswith("int"):
            # tlab_tpu's plane fractions are float32
            a = tavg.read_table(str(tmp_path / "t" / n))["gamma"]
            b = tavg.read_table(str(tmp_path / "j" / n))["gamma"]
            assert np.max(np.abs(a - b)) <= 1e-7 and np.ptp(a) > 0.1
            continue
        if not n.startswith("pdf"):
            assert got == (tmp_path / "j" / n).read_bytes(), n
            continue
        tag = n.split(".")[1]
        rf.write_pdf_file(str(tmp_path / "h"), n, 0.25, tsim.grid.y.nodes,
                          rf.pdf1v_plane_table(fields[tag].numpy(), 32), 32)
        assert got == (tmp_path / "h" / n).read_bytes(), n
        a = rf.read_pdf_file(str(tmp_path / "t" / n))[2]
        b = rf.read_pdf_file(str(tmp_path / "j" / n))[2]
        assert np.all(np.abs(a[:, :32] - b[:, :32]).sum(1) <= 1), n


def test_phase_average_matches_jax(tmp_path):
    """PhaseAverage: the same fields accumulated at the same steps give
    the same slot sums, stresses and counts (1e-12), and the same file."""
    rng = np.random.default_rng(2)
    shape = (6, 5, 8)
    pt = tphase.PhaseAverage.create(2, 6, 6, 5, n_scalars=1)
    pj = jphase.PhaseAverage.create(2, 6, 6, 5, n_scalars=1)
    for it in range(1, 13):
        f = {n: rng.standard_normal(shape) for n in ("u", "v", "w", "p",
                                                     "s1")}
        pt.accumulate(it, {k: torch.as_tensor(a) for k, a in f.items()})
        pj.accumulate(it, {k: jnp.asarray(a) for k, a in f.items()})
    assert np.array_equal(pt.counts, pj.counts) and pt.counts.sum() == 6
    _close(pt.sums, pj.sums, "sums", 1e-12)
    _close(pt.stress_sums, pj.stress_sums, "stresses", 1e-12)
    _close(pt.stress("u", "v", 1), pj.stress("u", "v", 1), "stress", 1e-12)
    pt.save(str(tmp_path / "t.npz"), 12)
    back = tphase.PhaseAverage.load(str(tmp_path / "t.npz"))
    assert back.names == pj.names and back.stride == 2
    assert np.array_equal(back.sums, pt.sums)


@pytest.fixture(scope="module")
def surfaces(pair):
    """The enstrophy indicator of the state and both interface heights
    through each package."""
    from tlab_tpu import mappings as jmp
    from tlab_tpu_torch import mappings as tmp
    jsim, js, tsim, ts = pair
    y = tsim.grid.y.nodes
    at = tmp.vorticity_magnitude2(tsim.P, ts.u, ts.v, ts.w)
    aj = jmp.vorticity_magnitude2(jsim.P, js.u, js.v, js.w)
    amin = 0.2 * float(jnp.max(aj))
    return (y, at, aj, amin,
            [tsl.upper_boundary(y, at, amin), tsl.lower_boundary(y, at,
                                                                 amin)],
            [jsl.upper_boundary(y, aj, amin), jsl.lower_boundary(y, aj,
                                                                 amin)])


def test_superlayer_heights_match_jax(surfaces):
    y, _, _, _, got, ref = surfaces
    for a, b in zip(got, ref):
        _close(a, b, "height")
        assert float(torch.amin(a)) >= y[0] and float(torch.amax(a)) <= y[-1]
    for a, b in zip(got, ref):
        st, sj = tsl.surface_statistics(a), jsl.surface_statistics(b)
        for k in sj:
            _close(st[k], sj[k], k)
        ct, et = tsl.height_pdf(a, 16)
        cj, ej = jsl.height_pdf(b, 16)
        assert np.array_equal(ct, cj)
        _close(et, ej, "edges", 1e-12)
    ct, *_ = tsl.surface_jpdf(got[0], got[1], 8)
    cj, *_ = jsl.surface_jpdf(ref[0], ref[1], 8)
    assert np.array_equal(ct, cj)


@pytest.mark.parametrize("side", ["upper", "lower"])
def test_superlayer_samples_match_jax(pair, surfaces, side):
    jsim, js, tsim, ts = pair
    y, at, aj, _, got, ref = surfaces
    k = 0 if side == "upper" else 1
    _close(tsl.sample_at_surface(ts.u, y, got[k], (0.0, 0.05)),
           jsl.sample_at_surface(js.u, y, ref[k], (0.0, 0.05)), "vertical")
    _close(tsl.surface_normals(tsim.grid, got[k]),
           jsl.surface_normals(jsim.grid, ref[k]), "normals")
    _close(tsl.sample_along_normals(tsim.grid, at, got[k], (0.0, 0.1),
                                    side=side),
           jsl.sample_along_normals(jsim.grid, aj, ref[k], (0.0, 0.1),
                                    side=side), "normal samples")


def test_locator_matches_jax(pair):
    """make_locator + interpolate_to_particles at random points (beyond the
    periodic ends and the walls too)."""
    from tlab_tpu.particles import core as jcore
    from tlab_tpu_torch.particles import core as tcore
    jsim, js, tsim, ts = pair
    pos = np.random.default_rng(4).uniform(-0.5, 2.5, (200, 3))
    got = tcore.interpolate_to_particles(
        ts.u, tcore.make_locator(tsim.grid)(torch.as_tensor(pos)))
    ref = jcore.interpolate_to_particles(
        js.u, jcore.make_locator(jsim.grid)(jnp.asarray(pos)))
    _close(got, ref, "gather", 1e-13)
    # the particles themselves, once refused (ROADMAP A15): the same
    # positions from the same draw
    ps = tcore.init_particles(tsim.grid, 64, seed=3, device="cpu")
    assert np.array_equal(ps.x.numpy(), np.asarray(
        jcore.init_particles(jsim.grid, 64, seed=3).x))
