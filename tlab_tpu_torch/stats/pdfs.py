"""Probability density functions (reference src/statistics/pdf.f90 +
tools/statistics/pdfs.f90; port of tlab_tpu/stats/pdfs.py).

Per-y-plane 1-D histograms with the reference's adaptive two-pass range
(PDF_ANALIZE), joint 2-D histograms with per-u-bin adaptive v ranges
(PDF2V), and the pdfs.x analysis-mode menu (ParamPdfs, pdfs.f90:193-800):
  1  main variables (u, v, w, p, scalars)
  2  scalar-gradient G_iG_i equation (GiGi, LnGiGi, production,
     diffusion, normal strain)
  3  enstrophy equation (WiWi, LnWiWi, production, diffusion,
     dilatation, baroclinic, rate)
  4  strain equation (2SijSij, Ln2SijSij, production, diffusion,
     pressure-strain)
  5  velocity-gradient invariants -> joint pdf (R, Q)      [pdf<it>.RQ]
  6  chi-flamelet strain (StrainAGiGi, StrainA)
  7  joint enstrophy and strain (log W_iW_i, log 2S_ijS_ij) [pdf<it>.WS]
  9  joint scalar and scalar gradient (s, ln G_iG_i)       [pdf<it>.SLnG]
  10 scalar-gradient components (Gx, Gy, Gz, Gtheta, Gphi) + GphiS joint
  11 rate-of-strain eigenvalues (Lambda1/2/3)
  12 eigenframe alignment cosines (cos(w,lambda_i), cos(G,lambda_i))
  13 longitudinal velocity derivatives (Sxx, Syy, Szz)
  14 potential vorticity (LnPotentialEnstrophy, CosPotentialEnstrophy)
  15 joint buoyancy and v [pdf<it>.bv] + b/v marginals
The fields are computed on the state's device; the 1-D tables of a
whole field are reduced there too (pdf1v_plane_table_device, equal to the
host table bit for bit), the gated, joint and conditional tables are the
host NumPy ones of io/reference_formats.py; all in the reference binary
layout, so scripts/python/PlotPdfs.py reads them unmodified.  gate_level >
0 conditions the 1-D pdfs on scalar1 > gate_level (the reference's
intermittency partition).

Counts are integers (int64 on the device, float64 in the tables), whatever
the field's dtype: a float32 counter stops at 2^24, which the whole-volume
row of a 512x256x256 field passes.
"""
from __future__ import annotations

import numpy as np
import torch

from tlab_tpu_torch.io import reference_formats as rf


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def pdf_per_plane(a, nbins: int = 64, vmin=None, vmax=None, gate=None):
    """Device-side histogram of `a` per y-plane (fast path for in-run
    monitoring; the reference-exact host tables are in
    reference_formats.pdf1v_plane_table): float64 counts (weights of the
    gate), edges (ny, nbins + 1)."""
    nx, ny, nz = a.shape
    ap = a.movedim(1, 0).reshape(ny, nx * nz)
    lo = torch.amin(ap, dim=1) if vmin is None else torch.full(
        (ny,), vmin, dtype=a.dtype, device=a.device)
    hi = torch.amax(ap, dim=1) if vmax is None else torch.full(
        (ny,), vmax, dtype=a.dtype, device=a.device)
    span = torch.where(hi > lo, hi - lo, 1.0)
    idx = torch.clamp(((ap - lo[:, None]) / span[:, None]
                       * nbins).to(torch.int32), 0, nbins - 1)
    weights = torch.ones_like(ap, dtype=torch.float64) if gate is None \
        else gate.movedim(1, 0).reshape(ny, nx * nz).to(torch.float64)
    counts = torch.zeros((ny, nbins), dtype=torch.float64, device=a.device)
    counts.scatter_add_(1, idx.to(torch.int64), weights)
    edges = lo[:, None] + (hi - lo)[:, None] * torch.linspace(
        0, 1, nbins + 1, dtype=a.dtype, device=a.device)[None]
    return counts, edges


def _bincount_rows(up, keep, nbins: int):
    """Per-row counts (R, nbins) of the bin indices `up` (R, n) where
    `keep` holds (all where None), in int64."""
    R = up.shape[0]
    if keep is not None:
        up = torch.where(keep, up, nbins)           # a bin past the last
    flat = (up + torch.arange(R, device=up.device)[:, None] * (nbins + 1))
    counts = torch.bincount(flat.reshape(-1), minlength=R * (nbins + 1))
    return counts.reshape(R, nbins + 1)[:, :nbins]


def _two_pass_rows(samples, nbins: int):
    """PDF1V2D (ilim=1) + PDF_ANALIZE + PDF1V2D (ilim=0) on each row of
    `samples` (R, n) float64, in the order of operations of
    reference_formats.pdf1v2d/pdf_analize, so that the rows equal the host
    tables bit for bit: (R, nbins + 2) float64."""
    one = torch.ones((), dtype=torch.float64, device=samples.device)
    # first pass on the sample range, the last point folded into the last bin
    umin, umax = torch.amin(samples, dim=1), torch.amax(samples, dim=1)
    ustep = (umax - umin) / nbins
    c0, c1 = umin + 0.5 * ustep, umax - 0.5 * ustep
    step = torch.where(ustep == 0.0, one, ustep)
    up = ((samples - umin[:, None]) / step[:, None]).to(torch.int64)
    counts1 = _bincount_rows(torch.clamp(up, max=nbins - 1), None, nbins)
    # PDF_ANALIZE: trim bins below plim * max-count from both ends
    ustep = (c1 - c0) / (nbins - 1) if nbins > 1 else torch.ones_like(c0)
    umin, umax = c0 - 0.5 * ustep, c1 + 0.5 * ustep
    pmin = 1.0e-4 * torch.amax(counts1, dim=1).to(torch.float64)
    idx = torch.arange(nbins, device=samples.device)
    mask = counts1 > pmin[:, None]
    first = torch.amin(torch.where(mask, idx, nbins), dim=1)
    last = torch.amax(torch.where(mask, idx, -1), dim=1)
    lo = torch.where(ustep == 0.0, umin, umin + first * ustep)
    hi = torch.where(ustep == 0.0, umax, umin + (last + 1) * ustep)
    # second pass on the trimmed range, outliers dropped; the float->int
    # conversion truncates toward zero as the host NumPy/Fortran INT()
    ustep = (hi - lo) / nbins
    c0, c1 = lo + 0.5 * ustep, hi - 0.5 * ustep
    step = torch.where(ustep == 0.0, one, ustep)
    up = ((samples - lo[:, None]) / step[:, None]).to(torch.int64)
    counts = _bincount_rows(up, (up >= 0) & (up <= nbins - 1), nbins)
    return torch.cat([counts.to(torch.float64), c0[:, None], c1[:, None]],
                     dim=1)


def pdf1v_plane_table_device(field, nbins: int):
    """Device-side reference-exact ibc=2 adaptive two-pass PDF table:
    per-y-plane rows + whole-volume row, (ny+1, nbins+2) float64, equal to
    reference_formats.pdf1v_plane_table (PDF1V2D + PDF_ANALIZE,
    pdfs.f90:28-111,329-375).  The samples are binned in float64 whatever
    the field's dtype, as the host tables bin them.  Lets the in-run pdf
    cadence fetch only the table instead of the full 3-D field."""
    nx, ny, nz = field.shape
    f64 = field.to(torch.float64)
    planes = _two_pass_rows(f64.movedim(1, 0).reshape(ny, nx * nz), nbins)
    volume = _two_pass_rows(f64.reshape(1, -1), nbins)
    return torch.cat([planes, volume], dim=0)


def _pdf1v_out(outdir, itime, rtime, y, tag, field, nbins, gate=None):
    if gate is None and torch.is_tensor(field):
        # the device table: bit for bit the host one, without the field's
        # copy and the host's passes over it
        rows = pdf1v_plane_table_device(field, nbins).cpu().numpy()
        rf.write_pdf_file(outdir, f"pdf{itime}.{tag}", rtime, y, rows, nbins)
        return
    f = _np(field)
    if gate is not None:
        # conditioned histogram: keep gate samples only (per plane)
        rows = np.zeros((f.shape[1] + 1, nbins + 2))
        g = np.asarray(gate)
        sets = [(f[:, j, :][g[:, j, :]], j) for j in range(f.shape[1])]
        sets.append((f[g], f.shape[1]))
        for sample, j in sets:
            if sample.size == 0:
                continue
            row = rf.pdf1v2d(sample, nbins, ilim=1)
            lo, hi = rf.pdf_analize(nbins, row)
            rows[j] = rf.pdf1v2d(sample, nbins, ilim=0,
                                 umin_ext=lo, umax_ext=hi)
    else:
        rows = rf.pdf1v_plane_table(f, nbins=nbins, ibc=2)
    rf.write_pdf_file(outdir, f"pdf{itime}.{tag}", rtime, y, rows, nbins)


def _pdf2v_out(outdir, itime, rtime, y, tag, u, v, nbins2):
    rows = rf.pdf2v_table(_np(u), _np(v), nbins2)
    rf.write_pdf_file(outdir, f"pdf{itime}.{tag}", rtime, y, rows,
                      list(nbins2))


def _buoyancy_field(sim, state):
    """b(s) with zero background reference (the pdfs.x convention: the
    reference zeroes bbackground/wrk1d before Gravity_Buoyancy,
    pdfs.f90:404-409, 709-714); None without an active body force."""
    props = sim.case.buoyancy
    if props is None or props.type == "none":
        return None
    from tlab_tpu_torch.physics.gravity import buoyancy_field
    ref = state.u.new_zeros(sim.grid.y.nodes.shape[0])
    return buoyancy_field(props, state.s, ref)


def _diagnostic_pressure(P, state, pressure):
    if pressure is None:
        from tlab_tpu_torch.dycore.pressure import pressure_boussinesq
        pressure = pressure_boussinesq(P, state)
    return pressure


def mode_fields(sim, state, pressure, opt_main: int = 1):
    """The 3-D fields of one ParamPdfs analysis mode
    (pdfs.f90:193-800): (marginals [(tag, field)...],
    joints [(tag, u_field, v_field)...]).  Separated from the histogram
    writer so tests can assert the fields themselves."""
    from tlab_tpu_torch import mappings as mp
    from tlab_tpu_torch.dycore import incompressible as dyn
    P = sim.P
    visc = sim.nsp.visc
    u, v, w = state.u, state.v, state.w
    ns = state.s.shape[0]
    tiny = 1e-300
    singles = []
    joints = []

    def grad(a):
        return (dyn._d1(P, "x", 0, a), dyn._d1(P, "y", 1, a),
                dyn._d1(P, "z", 2, a))

    if opt_main == 1:
        singles = [("u", u), ("v", v), ("w", w)]
        if pressure is not None:
            singles.append(("p", pressure))
        singles += [(f"s{i + 1}", state.s[i]) for i in range(ns)]

    elif opt_main == 2 and ns:
        # scalar-gradient equation (pdfs.f90:376-394)
        s0 = state.s[0]
        gigi = mp.gradient_magnitude2(P, s0)
        prod = mp.gradient_production(P, s0, u, v, w)
        diffu = sim.nsp.diffusivity(0) * mp.gradient_diffusion(P, s0)
        singles = [("GiGi", gigi), ("LnGiGi", torch.log(gigi + tiny)),
                   ("ProductionMsGiGjSij", prod),
                   ("DiffusionNuGiLapGi", diffu),
                   ("StrainAMsNiNjSij", prod / (gigi + tiny))]

    elif opt_main == 3:
        # enstrophy equation (pdfs.f90:398-451)
        wiwi = mp.vorticity_magnitude2(P, u, v, w)
        prod = mp.vorticity_production(P, u, v, w)
        diffu = visc * mp.vorticity_diffusion(P, u, v, w)
        inv_p = -dyn.divergence(P, u, v, w)       # FI_INVARIANT_P
        b = _buoyancy_field(sim, state)
        ox, oy, oz = mp.curl(P, u, v, w)
        if b is not None:
            # curl of the buoyancy force (0, b g_y, 0):
            # (-d(b gy)/dz, 0, d(b gy)/dx) dotted with the vorticity
            bf = b * sim.case.buoyancy.vector[1]
            baro = (ox * (-dyn._d1(P, "z", 2, bf))
                    + oz * dyn._d1(P, "x", 0, bf))
        else:
            baro = torch.zeros_like(wiwi)
        singles = [("WiWi", wiwi), ("LnWiWi", torch.log(wiwi + tiny)),
                   ("ProductionWiWjSij", prod),
                   ("DiffusionNuWiLapWi", diffu),
                   ("DilatationMsWiWiDivU", inv_p * wiwi),
                   ("Baroclinic", baro),
                   ("RateANiNjSij", prod / (wiwi + tiny))]

    elif opt_main == 4:
        # strain equation (pdfs.f90:455-486); needs the diagnostic p
        pressure = _diagnostic_pressure(P, state, pressure)
        s2 = 2.0 * mp.strain2(P, u, v, w)
        singles = [("2SijSij", s2), ("Ln2SijSij", torch.log(s2 + tiny)),
                   ("ProductionMs2SijSjkS_ki",
                    2.0 * mp.strain_production(P, u, v, w)),
                   ("DiffusionNuSijLapSij",
                    2.0 * visc * mp.strain_diffusion(P, u, v, w)),
                   ("Pressure2SijPij",
                    2.0 * mp.strain_pressure(P, u, v, w, pressure))]

    elif opt_main == 5:
        _, Q, R = mp.invariants(P, u, v, w)
        joints = [("RQ", R, Q)]

    elif opt_main == 6 and ns:
        # chi-flamelet strain (pdfs.f90:510-519)
        strain1, strain2_, _ = mp.strain_a(P, state.s[0], u, v, w)
        singles = [("StrainAGiGi", strain1), ("StrainA", strain2_)]

    elif opt_main == 7:
        ww = mp.vorticity_magnitude2(P, u, v, w)
        ss = 2.0 * mp.strain2(P, u, v, w)
        joints = [("WS", torch.log(ww + tiny), torch.log(ss + tiny))]

    elif opt_main == 9 and ns:
        gigi = mp.gradient_magnitude2(P, state.s[0])
        joints = [("SLnG", state.s[0], torch.log(gigi + tiny))]

    elif opt_main == 10 and ns:
        # scalar-gradient components + angles (pdfs.f90:566-591)
        gx, gy, gz = grad(state.s[0])
        mag = torch.sqrt(gx * gx + gy * gy + gz * gz)
        gphi = torch.arcsin(gy / torch.clamp(mag, min=1e-30))  # with Oy
        gtheta = torch.arctan2(gz, gx)                   # with Ox in xOz
        singles = [("Gx", gx), ("Gy", gy), ("Gz", gz),
                   ("Gtheta", gtheta), ("Gphi", gphi)]
        joints = [("GphiS", gtheta, gphi)]

    elif opt_main == 11:
        # rate-of-strain eigenvalues (pdfs.f90:595-606)
        from tlab_tpu_torch.stats.analysis import _grad9, _sym_eigenvalues
        g = _grad9(P, u, v, w)
        l1, l2, l3 = _sym_eigenvalues(
            g["ux"], g["vy"], g["wz"],
            0.5 * (g["uy"] + g["vx"]), 0.5 * (g["uz"] + g["wx"]),
            0.5 * (g["vz"] + g["wy"]))
        singles = [("Lambda1", l1), ("Lambda2", l2), ("Lambda3", l3)]

    elif opt_main == 12:
        # eigenframe alignment (pdfs.f90:610-661)
        from tlab_tpu_torch.stats.analysis import eigenframe_cosine_fields
        cf = eigenframe_cosine_fields(P, state)
        names = {"cosWL1": "cos(w,lambda1)", "cosWL2": "cos(w,lambda2)",
                 "cosWL3": "cos(w,lambda3)", "cosGL1": "cos(G,lambda1)",
                 "cosGL2": "cos(G,lambda2)", "cosGL3": "cos(G,lambda3)"}
        singles = [(tag, cf[k]) for k, tag in names.items() if k in cf]

    elif opt_main == 13:
        # longitudinal velocity derivatives (pdfs.f90:665-676)
        singles = [("Sxx", dyn._d1(P, "x", 0, u)),
                   ("Syy", dyn._d1(P, "y", 1, v)),
                   ("Szz", dyn._d1(P, "z", 2, w))]

    elif opt_main == 14 and ns:
        # potential vorticity w.grad(s1) (pdfs.f90:680-703)
        ox, oy, oz = mp.curl(P, u, v, w)
        wiwi = ox * ox + oy * oy + oz * oz
        gx, gy, gz = grad(state.s[0])
        pv = ox * gx + oy * gy + oz * gz
        normb = torch.sqrt(gx * gx + gy * gy + gz * gz + 1e-30)
        normw = torch.sqrt(wiwi + 1e-30)
        singles = [("LnPotentialEnstrophy", torch.log(pv * pv + 1e-30)),
                   ("CosPotentialEnstrophy", pv / (normb * normw))]

    elif opt_main == 15:
        # joint analysis of buoyancy and vertical velocity
        # (pdfs.f90:707-800): pdf<it>.bv + the two marginals
        b = _buoyancy_field(sim, state)
        if b is None:
            raise ValueError("ParamPdfs mode 15 needs [BodyForce]")
        b = b / sim.case.ini.get_float("Parameters", "Froude", 1.0)
        singles = [("b", b), ("v", v)]
        joints = [("bv", b, v)]

    else:
        raise NotImplementedError(f"ParamPdfs mode {opt_main}")

    return singles, joints


def run_pdf_mode(sim, state, pressure, outdir: str, itime: int,
                 rtime: float, opt_main: int = 1, nbins=(32, 32),
                 gate_level: float = 0.0, fields=None) -> None:
    """One ParamPdfs analysis mode on a snapshot: compute the mode's
    fields and write reference-layout pdf<it>.<tag> files.  fields: the
    mode's (singles, joints) of mode_fields where the caller has them."""
    y = sim.grid.y.nodes
    nb = int(np.atleast_1d(nbins)[0])
    nb2 = (int(np.atleast_1d(nbins)[0]),
           int(np.atleast_1d(nbins)[-1]))
    gate = None
    if gate_level > 0.0 and state.s.shape[0]:
        gate = _np(state.s[0]) > gate_level
    singles, joints = fields or mode_fields(sim, state, pressure, opt_main)
    for tag, a in singles:
        _pdf1v_out(outdir, itime, rtime, y, tag, a, nb, gate=gate)
    for tag, a, b in joints:
        _pdf2v_out(outdir, itime, rtime, y, tag, a, b, nb2)

    from tlab_tpu_torch import mappings as mp
    if opt_main == 9 and state.s.shape[0]:
        # conditional averages (pdfs.f90:546-553): mean GiGi / LnGiGi on
        # bins of s (the first var, ibc=1 local range)
        gigi = _np(mp.gradient_magnitude2(sim.P, state.s[0]))
        s_np = _np(state.s[0])
        for fname, fld in (("cavgGiGi", gigi),
                           ("cavgLnGiGi", np.log(gigi + 1e-300))):
            rows = rf.cavg1v_plane_table(s_np, fld, nb, ibc=1)
            rf.write_pdf_file(outdir, f"{fname}{itime}.s", rtime, y,
                              rows, nb)

    elif opt_main == 15:
        # conditional-average suite (pdfs.f90:719-800): each diagnostic
        # averaged on bins of b, of v, and on the joint (b, v)
        from tlab_tpu_torch.dycore import incompressible as dyn
        b_f = dict(singles)["b"]
        pressure = _diagnostic_pressure(sim.P, state, pressure)
        fields = {"B": b_f,
                  "Bii": mp.laplacian(sim.P, b_f),
                  "U": state.u, "W": state.w,
                  "Vii": mp.laplacian(sim.P, state.v),
                  "P": pressure,
                  "Py": dyn._d1(sim.P, "y", 1, pressure)}
        b_np = _np(b_f)
        v_np = _np(state.v)
        for fname, fld in fields.items():
            fld = _np(fld)
            for tag, cond in (("b", b_np), ("v", v_np)):
                rows = rf.cavg1v_plane_table(cond, fld, nb, ibc=1)
                rf.write_pdf_file(outdir, f"cavg{fname}{itime}.{tag}",
                                  rtime, y, rows, nb)
            rows = rf.cavg2v_table(b_np, v_np, fld, nb2)
            rf.write_pdf_file(outdir, f"cavg{fname}{itime}.bv", rtime, y,
                              rows, list(nb2))


def write_pdf(path: str, counts, edges, itime: int) -> None:
    """Legacy npz writer (kept for in-memory analysis helpers)."""
    np.savez(path, counts=_np(counts), edges=_np(edges), itime=itime)
