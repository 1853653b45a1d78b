"""Wavefront-differential tolerancing tools (Code V TOR-style).

Counterpart of ``prysm_tpu/x/raytracing/wavefront_differential.py``: a
quadratic RMS model RMS^2(tau) = C + B.tau + tau'G tau built from
per-tolerance wavefront derivative maps of one launch bundle.  The default
map source is the forward-mode tangent engine (one ``torch.func.jvp``
sweep per tolerance through the trace + reference-sphere closing,
``_diff_raytrace.wavefront_with_tangents``, on ``config.device``);
``method='fd'`` keeps the central-finite-difference path as an
independent cross-check.  Everything downstream (sensitivities, Zernike
sensitivity, compensator projection, RSS roll-up, inverse sensitivity and
fast Monte Carlo over the quadratic) is host float64 numpy, as in the JAX
package.
"""
import numpy as np
import torch

from ...conf import config

from .analysis import wavefront_zernike_fit, _wavefront_from_trace
from .analysis import resolve_exit_pupil
from .spencer_and_murty import raytrace, to_host
from .opt import _pupil_center_chief_index
from ._resolve import resolve_wavelength
from .tolerance import MonteCarloResult

_PREC = np.float64


def _closed_wavefront(lensdata, P, S, wavelength, *, chief_index, P_xp,
                      field, axis_point, axis_dir):
    surfaces = lensdata.to_surfaces()
    trace = raytrace(surfaces, P, S, wavelength)
    opd, x_pupil, y_pupil, valid = _wavefront_from_trace(
        lensdata, P, wavelength, trace, P_xp=P_xp,
        chief_index=chief_index, field=field, output='length')
    return opd, x_pupil, y_pupil, valid


def _xp_z_tangents_robust(surfaces, wavelength, seeds, stop_index):
    """Per-seed exit-pupil z tangents: analytic where paraxially
    eligible, host central differences of the ynu walk otherwise."""
    from ._diff_raytrace import (
        paraxial_exit_pupil_z_tangents,
        _paraxial_seed_arrays,
    )
    from .adjoint.engine import apply_seeds
    from .paraxial import ynu_first_order, NonAxialSystemError

    out = np.zeros(len(seeds), dtype=_PREC)
    if not seeds:
        return out
    # one batched analytic call covers the common all-eligible set
    d = paraxial_exit_pupil_z_tangents(
        surfaces, wavelength, seeds, stop_index=stop_index)
    if d is not None:
        return np.asarray(d, dtype=_PREC)
    eligible = [k for k, sd in enumerate(seeds)
                if _paraxial_seed_arrays(surfaces, [sd]) is not None]
    analytic = frozenset()
    if eligible:
        d = paraxial_exit_pupil_z_tangents(
            surfaces, wavelength, [seeds[k] for k in eligible],
            stop_index=stop_index)
        if d is not None:
            out[eligible] = d
            analytic = frozenset(eligible)
        # else: degenerate (telecentric) nominal — fall through to FD,
        # which detects the None xp_z per probe and zeros the tangent
    h = 1e-6
    for k, seed in enumerate(seeds):
        if k in analytic:
            continue
        zs = []
        for sgn in (+1.0, -1.0):
            step = torch.full((1,), sgn * h, dtype=config.precision,
                              device=config.device)
            ss = apply_seeds(surfaces, [seed], step)
            try:
                xp_z = ynu_first_order(ss, wavelength,
                                       stop_index=stop_index).xp_z
                zs.append(None if xp_z is None else float(xp_z))
            except NonAxialSystemError:
                # a transverse decenter/tilt breaks the axial ynu walk,
                # but does not move the paraxial pupil to first order
                zs.append(None)
        if zs[0] is None or zs[1] is None:
            continue  # telecentric under perturbation: no stable tangent
        out[k] = (zs[0] - zs[1]) / (2.0 * h)
    return out


def _tangent_maps(lensdata, perturbations, compensators, P, S, wavelength, *,
                  chief_index, axis_point, axis_dir, P_xp, field, pose_step,
                  extra_seeds=()):
    """(opd, x_pupil, y_pupil, dW) from the forward-mode tangent engine.

    Column order: perturbations, then raw extra seeds (surface
    irregularities etc.), then compensators.
    """
    from ._diff_raytrace import (
        seeds_from_perturbations,
        wavefront_with_tangents,
    )

    seeds = (seeds_from_perturbations(perturbations, pose_step=pose_step)
             + list(extra_seeds)
             + seeds_from_perturbations(compensators, pose_step=pose_step))
    surfaces = lensdata.to_surfaces()
    P_xp_dot = None
    reference_curvature = None
    reference_curvature_dot = None
    stop_index = getattr(lensdata, 'stop_index', None)
    if P_xp is None and stop_index is not None:
        P_xp, xp_mode = resolve_exit_pupil(
            lensdata, wavelength, field=field, return_mode=True)
        if xp_mode == 'paraxial':
            xp_z_dot = _xp_z_tangents_robust(
                surfaces, wavelength, seeds, stop_index)
            if P_xp is None:
                # telecentric limit: kappa behaves as |D|, central
                # derivative zero — the FD adapter's convention
                reference_curvature = 0.0
                reference_curvature_dot = np.zeros(len(seeds), dtype=_PREC)
            else:
                P_xp_dot = np.zeros((3, len(seeds)), dtype=_PREC)
                P_xp_dot[2] = xp_z_dot
    return wavefront_with_tangents(
        surfaces, P, S, wavelength, seeds,
        chief_index=chief_index,
        axis_point=axis_point, axis_dir=axis_dir, P_xp=P_xp,
        P_xp_dot=P_xp_dot,
        reference_curvature=reference_curvature,
        reference_curvature_dot=reference_curvature_dot,
        field=field, output='length')


def wavefront_differential(lensdata, perturbations, P, S, wavelength, *,
                           compensators=None, comp_rcond=1e-9,
                           chief_index=None, axis_point=None, axis_dir=None,
                           P_xp=None, field=None, fd_step=None,
                           pose_step=1e-6, method='tangent',
                           rms_reference='chief',
                           extra_seeds=None, extra_steps=None):
    """Build a wavefront-differential model from one launch bundle.

    perturbations define the parameter-axis order; compensators are
    projected out by least squares.  extra_seeds appends raw DiffSeed
    tolerance columns (surface irregularities and other effects with no
    LensData slot) after the perturbations, with extra_steps their
    per-unit scales.  method='tangent' (default) builds every
    derivative map from one forward-mode AD sweep per column;
    method='fd' uses central finite differences of the closed wavefront
    (fd_step overrides the half-step, default 1e-6 scaled by nominal).
    """
    perturbations = list(perturbations)
    compensators = list(compensators) if compensators else []
    extra_seeds = list(extra_seeds) if extra_seeds else []
    if extra_steps is None:
        extra_steps = [1.0] * len(extra_seeds)
    extra_steps = [float(s) for s in extra_steps]
    if len(extra_steps) != len(extra_seeds):
        raise ValueError('extra_steps must parallel extra_seeds')
    wavelength = resolve_wavelength(lensdata, wavelength)
    P = np.asarray(to_host(P), dtype=_PREC)
    S = np.asarray(to_host(S), dtype=_PREC)

    if chief_index is None:
        chief_index = _pupil_center_chief_index(P)

    if method == 'tangent':
        opd0, x_pupil, y_pupil, dW = _tangent_maps(
            lensdata, perturbations, compensators, P, S, wavelength,
            chief_index=chief_index, axis_point=axis_point,
            axis_dir=axis_dir, P_xp=P_xp, field=field, pose_step=pose_step,
            extra_seeds=extra_seeds)
        return _assemble_model(
            opd0, dW, x_pupil, y_pupil, perturbations, compensators,
            comp_rcond=comp_rcond, rms_reference=rms_reference,
            extra_seeds=extra_seeds, extra_steps=extra_steps)
    if extra_seeds:
        raise ValueError("extra_seeds require method='tangent'")
    if method != 'fd':
        raise ValueError(f"method must be 'tangent' or 'fd', got {method!r}")

    resolve_xp = (P_xp is None
                  and getattr(lensdata, 'stop_index', None) is not None)
    if resolve_xp:
        from .paraxial import NonAxialSystemError
        xp_nominal = resolve_exit_pupil(lensdata, wavelength, field=field)

    def closed():
        # re-resolve a stop-driven exit pupil each probe so the finite
        # difference carries d(P_xp)/d(tau), matching the tangent engine
        if resolve_xp:
            try:
                xp = resolve_exit_pupil(lensdata, wavelength, field=field)
            except NonAxialSystemError:
                # a decentered/tilted probe breaks the axial ynu walk;
                # transverse pose motion does not move the paraxial
                # pupil to first order, so the nominal anchor stands
                xp = xp_nominal
        else:
            xp = P_xp
        return _closed_wavefront(lensdata, P, S, wavelength,
                                 chief_index=chief_index, P_xp=xp,
                                 field=field, axis_point=axis_point,
                                 axis_dir=axis_dir)

    opd0, x_pupil, y_pupil, valid0 = closed()
    n = opd0.shape[0]

    def fd_map(p):
        # a small derivative step independent of the tolerance sigma —
        # the sigma can be far too coarse for an accurate derivative
        if fd_step is not None:
            h = float(fd_step)
        else:
            h = 1e-6 * max(1.0, abs(p.nominal))
        if h == 0.0:
            h = 1e-6
        try:
            p.set(p.nominal + h)
            wp = closed()[0]
            p.set(p.nominal - h)
            wm = closed()[0]
        finally:
            p.set(p.nominal)
        if wp.shape[0] != n or wm.shape[0] != n:
            raise ValueError(
                f'perturbation {p.name!r} changed the valid-ray set within '
                'its finite-difference step; reduce the step or prune '
                'marginal rays')
        return (wp - wm) / (2.0 * h)

    n_tol = len(perturbations)
    dW = np.empty((n, n_tol + len(compensators)), dtype=_PREC)
    for i, p in enumerate(perturbations + compensators):
        dW[:, i] = fd_map(p)

    return _assemble_model(opd0, dW, x_pupil, y_pupil, perturbations,
                           compensators, comp_rcond=comp_rcond,
                           rms_reference=rms_reference)


def _assemble_model(opd0, dW, x_pupil, y_pupil, perturbations,
                    compensators, *, comp_rcond, rms_reference,
                    extra_seeds=(), extra_steps=()):
    """Shared model assembly for the tangent and FD map sources."""
    if rms_reference not in ('chief', 'piston'):
        raise ValueError("rms_reference must be 'chief' or 'piston'")
    opd = np.asarray(opd0, dtype=_PREC)
    dW = np.asarray(dW, dtype=_PREC)
    if rms_reference == 'piston':
        opd = opd - np.mean(opd)
        dW = dW - np.mean(dW, axis=0, keepdims=True)

    names = [p.name or f'tol{i}' for i, p in enumerate(perturbations)]
    steps = [p.step for p in perturbations]
    variances = [p.variance for p in perturbations]
    for seed, step in zip(extra_seeds, extra_steps):
        names.append(seed.name or f'seed{len(names)}')
        steps.append(float(step))
        variances.append(float(step) ** 2)

    n_tol = len(perturbations) + len(extra_seeds)
    tol_maps = dW[:, :n_tol]
    if not compensators:
        return WavefrontDifferential(opd, tol_maps, names=names,
                                     steps=steps, variances=variances,
                                     reference=rms_reference,
                                     x_pupil=x_pupil, y_pupil=y_pupil)

    comp_maps = dW[:, n_tol:]
    comp_names = [c.name or f'comp{i}' for i, c in enumerate(compensators)]
    opd_c, tol_c, _ = compensate(opd, tol_maps, comp_maps, rcond=comp_rcond)
    # compensator motion rates dc/dtau = -M+ D use the UNprojected tol maps
    motions = -(np.linalg.pinv(comp_maps, rcond=comp_rcond) @ tol_maps)
    return WavefrontDifferential(opd_c, tol_c, names=names, steps=steps,
                                 variances=variances,
                                 reference=rms_reference,
                                 x_pupil=x_pupil, y_pupil=y_pupil,
                                 comp_names=comp_names,
                                 comp_maps=comp_maps, comp_motions=motions)


# ---------- compensator projection (SVD least squares) ----------------------

def _orthonormal_basis(M, rcond):
    """Orthonormal basis of col(M) for singular values above rcond*max."""
    M = np.asarray(M, dtype=_PREC)
    if M.ndim != 2 or M.shape[1] == 0:
        return M.reshape(M.shape[0], 0)
    U, s, _ = np.linalg.svd(M, full_matrices=False)
    if s.shape[0] == 0:
        return U[:, :0]
    rank = int(np.sum(s > rcond * s[0]))
    return U[:, :rank]


def project_out(v, basis):
    """(I - basis basis^T) v: the part of v orthogonal to the subspace."""
    basis = np.asarray(basis, dtype=_PREC)
    if basis.shape[1] == 0:
        return np.asarray(v, dtype=_PREC)
    v = np.asarray(v, dtype=_PREC)
    return v - basis @ (basis.T @ v)


def compensate(opd, tol_maps, comp_maps, *, rcond=1e-9):
    """Project the wavefront and tolerance maps off the compensators."""
    basis = _orthonormal_basis(comp_maps, rcond)
    return project_out(opd, basis), project_out(tol_maps, basis), basis


def _column(values, count, fallback):
    """values as a (count,) f64 vector, broadcasting scalars; None->fallback."""
    if values is None:
        return fallback
    arr = np.asarray(values, dtype=_PREC)
    return np.broadcast_to(arr, (count,)).copy() if arr.ndim == 0 else arr


class WavefrontDifferential:
    """Wavefront-error quadratic for one launch bundle and tolerance set.

    Holds RMS^2(tau) = C + B.tau + tau' G tau with G the Gram matrix of
    the derivative maps; every report/rollup/inverse query below is a
    closed-form read of (C, B, G).
    """

    __slots__ = ('W0', 'dW', 'names', 'steps', 'variances',
                 'x_pupil', 'y_pupil',
                 'n_samples', 'n_params', 'C', 'B', 'G', 'A', 'rms_nominal',
                 'comp_names', 'comp_maps', 'comp_motions', 'reference')

    def __init__(self, opd, dW, *, names=None, steps=None, variances=None,
                 reference='chief', x_pupil=None, y_pupil=None,
                 comp_names=None, comp_maps=None, comp_motions=None):
        if reference not in ('chief', 'piston'):
            raise ValueError("reference must be 'chief' or 'piston'")
        self.W0 = np.asarray(opd, dtype=_PREC).ravel()
        self.dW = np.asarray(dW, dtype=_PREC)
        if self.dW.ndim != 2 or self.dW.shape[0] != self.W0.shape[0]:
            raise ValueError(
                f'dW must be (N, P) parallel to opd (N={self.W0.shape[0]});'
                f' got {self.dW.shape}')
        self.n_samples, self.n_params = self.dW.shape
        P = self.n_params
        self.names = (list(names) if names is not None
                      else [f'tol{i}' for i in range(P)])
        self.steps = _column(steps, P, np.ones(P, dtype=_PREC))
        self.variances = _column(variances, P, self.steps * self.steps)
        self.reference = reference
        self.x_pupil = None if x_pupil is None else np.asarray(x_pupil)
        self.y_pupil = None if y_pupil is None else np.asarray(y_pupil)
        self.comp_names = None if comp_names is None else list(comp_names)
        self.comp_maps = (None if comp_maps is None
                          else np.asarray(comp_maps, dtype=_PREC))
        self.comp_motions = (None if comp_motions is None
                             else np.asarray(comp_motions, dtype=_PREC))

        # the quadratic itself: mean-over-samples inner products
        scale = 1.0 / self.n_samples
        self.C = float(self.W0 @ self.W0) * scale
        self.B = (self.W0 @ self.dW) * (2.0 * scale)
        self.G = (self.dW.T @ self.dW) * scale
        self.A = np.ascontiguousarray(np.diagonal(self.G))
        self.rms_nominal = float(np.sqrt(self.C))

    # ---------- per-tolerance quadratic ------------------------------------

    def quadratic_coeffs(self, p):
        """(A, B, C) of RMS^2(T) = A T^2 + B T + C for tolerance p alone."""
        return float(self.A[p]), float(self.B[p]), self.C

    def rms_at(self, p, T):
        """Predicted RMS with tolerance p at value T, others nominal."""
        T = np.asarray(T, dtype=_PREC)
        rms_sq = np.polyval(self.quadratic_coeffs(p), T)
        return np.sqrt(np.clip(rms_sq, 0.0, None))

    def sensitivity(self):
        """dRMS/dtau at nominal for every tolerance."""
        if self.rms_nominal == 0.0:
            # RMS ~ |T| at a perfect wavefront: report sqrt(A)
            return np.sqrt(self.A)
        return self.B * (0.5 / self.rms_nominal)

    # ---------- full quadratic form ----------------------------------------

    def predict_rms_sq(self, tau):
        """RMS^2(tau), vectorized over rows of tau."""
        tau = np.asarray(tau, dtype=_PREC)
        single = tau.ndim == 1
        tau = np.atleast_2d(tau)
        rms_sq = self.C + tau @ self.B + np.einsum(
            'tp,pq,tq->t', tau, self.G, tau)
        rms_sq = np.clip(rms_sq, 0.0, None)
        return float(rms_sq[0]) if single else rms_sq

    def predict_rms(self, tau):
        """sqrt(predict_rms_sq(tau))."""
        return np.sqrt(self.predict_rms_sq(tau))

    def gram(self):
        """The (P, P) cross-term Gram matrix mean(dW_p dW_q)."""
        return self.G

    # ---------- Zernike-coefficient sensitivities --------------------------

    def zernike_sensitivity(self, nms, *, normalization_radius=None,
                            norm=True):
        """(nominal_coefs, dcoefs): Zernike sensitivity to each tolerance."""
        if self.x_pupil is None or self.y_pupil is None:
            raise ValueError(
                'zernike_sensitivity needs the pupil coordinates; build '
                'the model via wavefront_differential (which records them)')
        nms = list(nms)
        x, y = self.x_pupil, self.y_pupil
        if normalization_radius is None:
            normalization_radius = float(np.sqrt(np.max(x * x + y * y)))

        def fit(column):
            coefs, _ = wavefront_zernike_fit(
                column, x, y, nms,
                normalization_radius=normalization_radius, norm=norm)
            return np.asarray(coefs, dtype=_PREC)

        # one fit per map: the nominal wavefront then every derivative map
        stacked = np.column_stack(
            [fit(m) for m in (self.W0, *self.dW.T)])
        return stacked[:, 0], stacked[:, 1:]

    # ---------- compensators -----------------------------------------------

    @property
    def is_compensated(self):
        """True when the model projects out a compensator subspace."""
        return self.comp_maps is not None

    def compensator_motions(self):
        """Per-tolerance compensator motion rate dc/dtau, shape (K, P)."""
        if self.comp_motions is None:
            raise ValueError('this model has no compensators')
        return self.comp_motions

    # ---------- RSS roll-up ------------------------------------------------

    def _scales(self, scales):
        return _column(scales, self.n_params, self.steps)

    def expected_rms_sq(self, scales=None):
        """E[RMS^2] for independent zero-mean tolerances."""
        variance = (self.variances if scales is None
                    else np.square(self._scales(scales)))
        return self.C + float(variance @ self.A)

    def expected_rms(self, scales=None):
        """sqrt(expected_rms_sq) -- the RSS-rolled-up predicted RMS."""
        return float(np.sqrt(max(self.expected_rms_sq(scales), 0.0)))

    def rms_change_per_tolerance(self, scales=None):
        """Per-tolerance RMS minus nominal at tau_p = +scale_p."""
        s = self._scales(scales)
        rms_sq = (self.A * s + self.B) * s + self.C
        return np.sqrt(np.clip(rms_sq, 0.0, None)) - self.rms_nominal

    # ---------- inverse sensitivity ----------------------------------------

    def inverse_sensitivity(self, target_delta_rms, *, tiny=1e-30):
        """(t_lo, t_hi): allowed tolerance range for a target RMS increase.

        Vectorized roots of A T^2 + B T + cc = 0 per tolerance with
        cc = C - RMS_target^2 (<= 0 for a positive target); degenerate
        quadratics fall back to the linear or unbounded solution.
        """
        target_rms = self.rms_nominal + float(target_delta_rms)
        cc = self.C - target_rms * target_rms
        A, B = self.A, self.B

        with np.errstate(divide='ignore', invalid='ignore'):
            # quadratic branch
            half_width = np.sqrt(np.clip(B * B - 4.0 * A * cc, 0.0, None))
            q_lo = (-B - half_width) / (2.0 * A)
            q_hi = (-B + half_width) / (2.0 * A)
            quad_lo = np.minimum(q_lo, q_hi)
            quad_hi = np.maximum(q_lo, q_hi)
            # linear branch (A ~ 0): one root, unbounded on one side
            lin_root = -cc / B

        linear = np.abs(A) <= tiny
        flat = linear & (np.abs(B) <= tiny)
        root_positive = lin_root >= 0
        t_lo = np.where(linear,
                        np.where(root_positive, -np.inf, lin_root),
                        quad_lo)
        t_hi = np.where(linear,
                        np.where(root_positive, lin_root, np.inf),
                        quad_hi)
        t_lo = np.where(flat, -np.inf, t_lo)
        t_hi = np.where(flat, np.inf, t_hi)
        return t_lo.astype(_PREC), t_hi.astype(_PREC)

    # ---------- fast Monte Carlo over the quadratic ------------------------

    def fast_monte_carlo(self, perturbations, n_trials, *, seed=None,
                         record_samples=False):
        """Monte Carlo over the quadratic (no retraces)."""
        perturbations = list(perturbations)
        if len(perturbations) != self.n_params:
            raise ValueError(
                f'expected {self.n_params} perturbations to match the '
                f'model, got {len(perturbations)}')
        rng = np.random.default_rng(seed)
        n_trials = int(n_trials)
        nominals = np.array([p.nominal for p in perturbations], dtype=_PREC)
        # draw column-by-column: each perturbation owns a contiguous batch
        sampled = np.column_stack([
            [p.sample(rng) for _ in range(n_trials)]
            for p in perturbations
        ]).astype(_PREC) if perturbations else np.empty((n_trials, 0), _PREC)
        merits = self.predict_rms(sampled - nominals)
        names = [p.name for p in perturbations]
        return MonteCarloResult(merits,
                                sampled if record_samples else None,
                                nominals, names)

    # ---------- reporting --------------------------------------------------

    def rows(self, scales=None):
        """Per-tolerance rows: name, A, B, C, sensitivity, delta_rms."""
        columns = {
            'name': self.names,
            'A': self.A,
            'B': self.B,
            'C': [self.C] * self.n_params,
            'scale': self._scales(scales),
            'sensitivity': self.sensitivity(),
            'delta_rms': self.rms_change_per_tolerance(scales),
        }
        rows = []
        for values in zip(*columns.values()):
            row = dict(zip(columns, values))
            rows.append({k: (v if k == 'name' else float(v))
                         for k, v in row.items()})
        return rows

    # (field, header, width) for sensitivity_table, in print order
    _TABLE_SPEC = (('name', 'name', '<20'), ('scale', 'scale', '>12'),
                   ('A', 'A', '>12'), ('B', 'B', '>12'),
                   ('sensitivity', 'dRMS/dtau', '>12'),
                   ('delta_rms', 'dRMS@scale', '>12'))

    def sensitivity_table(self, scales=None):
        """Column-aligned per-tolerance sensitivity report (a string)."""
        spec = self._TABLE_SPEC
        header = ' '.join(format(title, align)
                          for _, title, align in spec)
        body = (
            ' '.join(format(row[field], align if field == 'name'
                            else align + '.6g')
                     for field, _, align in spec)
            for row in self.rows(scales)
        )
        title = f'WavefrontDifferential(rms_nominal={self.rms_nominal:.6g}):'
        return '\n'.join([title, header, *body])

    def __repr__(self):
        return (f'WavefrontDifferential(n_samples={self.n_samples}, '
                f'n_params={self.n_params}, '
                f'rms_nominal={self.rms_nominal:.6g})')


def cumulative_probability(merits):
    """(thresholds, probability): empirical CDF of a merit sample."""
    thresholds = np.sort(np.asarray(getattr(merits, 'merits', merits),
                                    dtype=_PREC))
    count = thresholds.shape[0]
    return thresholds, np.linspace(1.0 / count, 1.0, count, dtype=_PREC)


__all__ = [
    'wavefront_differential',
    'WavefrontDifferential',
    'compensate',
    'project_out',
    'cumulative_probability',
]
