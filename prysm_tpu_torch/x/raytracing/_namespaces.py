"""Inner verb namespaces for OpticalSystem (opt / solve / analysis / ...).

Counterpart of ``prysm_tpu/x/raytracing/_namespaces.py``: every verb of
the JAX package, bound to the system.
"""


class _OptNamespace:
    """Design + optimization verbs over the system's DesignState."""

    __slots__ = ('_sys',)

    def __init__(self, system):
        self._sys = system

    def vary(self, category, surfaces='all'):
        """Mark a category of DOFs free; returns this namespace to chain."""
        self._sys._design.vary(category, surfaces)
        return self

    def vary_all(self):
        """Mark every scalar DOF free."""
        self._sys._design.vary_all()
        return self._sys

    def freeze(self, category, surfaces='all'):
        """Inverse of vary."""
        self._sys._design.freeze(category, surfaces)
        return self._sys

    def freeze_all(self):
        """Mark every scalar DOF fixed."""
        self._sys._design.freeze_all()
        return self._sys

    def constrain(self, category, *, lo=None, hi=None, relative=None,
                  surfaces='all'):
        """Box bounds on a category of DOFs."""
        self._sys._design.constrain(category, lo=lo, hi=hi,
                                    relative=relative, surfaces=surfaces)
        return self._sys

    def pickup(self, category, surface, *, from_surface, from_category=None,
               scale=1.0, offset=0.0):
        """Make DOFs pickups of others."""
        self._sys._design.pickup(category, surface,
                                 from_surface=from_surface,
                                 from_category=from_category, scale=scale,
                                 offset=offset)
        return self._sys

    def pack(self):
        """Dense free-DOF vector."""
        return self._sys._design.pack()

    def update(self, x):
        """Write a free vector back into the rows."""
        self._sys._design.update(x)
        return self._sys

    def bounds(self):
        """(lo, hi) arrays parallel to the free vector."""
        return self._sys._design.bounds()

    def problem(self, goal='spot', *, sampling=None, fields=None,
                wavelengths=None, constraints=None):
        """Assemble a design.Problem over this system's free vector."""
        from .design import build_problem
        return build_problem(self._sys, goal, sampling=sampling,
                             fields=fields, wavelengths=wavelengths,
                             constraints=constraints)

    def optimize(self, goal='spot', *, sampling=None, fields=None,
                 wavelengths=None, constraints=None, **solve_kwargs):
        """Build and solve an optimization problem in one shot."""
        prob = self.problem(goal, sampling=sampling, fields=fields,
                            wavelengths=wavelengths,
                            constraints=constraints)
        return prob.solve(**solve_kwargs)


class _SolveNamespace:
    """State-writing solves."""

    __slots__ = ('_sys',)

    def __init__(self, system):
        self._sys = system

    def image_distance(self, surface=None, *, wavelength=None):
        """Paraxial image-distance solve on a gap."""
        wvl = self._sys.wavelength(wavelength)
        self._sys._design.solve_image_distance(surface, wavelength=wvl)
        return self._sys

    def clear_image_distance(self):
        """Disable the active image-distance solve."""
        self._sys._design.clear_image_distance_solve()
        return self._sys

    def apertures(self, fields=None, wavelength=None, *, oversize=1.05):
        """Size auto surface apertures from the traced footprint."""
        from .launch import solve_apertures
        return solve_apertures(self._sys, fields=fields,
                               wavelength=wavelength, oversize=oversize)

    def vignetting(self, fields=None, wavelength=None, *, tol=1e-3):
        """Solve and store per-field vignetting factors."""
        from .launch import solve_vignetting
        return solve_vignetting(self._sys, fields, wavelength, tol=tol)


class _AnalysisNamespace:
    """Analysis verbs (wavefront, spots, fans, sweeps)."""

    __slots__ = ('_sys',)

    def __init__(self, system):
        self._sys = system

    def first_order(self, field=0, wavelength=None, **kwargs):
        """Parabasal first-order properties about a chief ray."""
        return self._sys.first_order(field=field, wavelength=wavelength,
                                     **kwargs)

    def exit_pupil(self, wavelength=None, field=None, **kwargs):
        """Resolved exit-pupil reference point (or None if telecentric)."""
        return self._sys.exit_pupil(wavelength, field=field, **kwargs)

    def __getattr__(self, name):
        from . import analysis as _analysis
        fn = getattr(_analysis, name, None)
        if fn is None or not callable(fn):
            raise NotImplementedError(
                f'analysis verb {name!r} is not available yet')
        sys = self._sys

        def bound(*args, **kwargs):
            return fn(sys, *args, **kwargs)

        bound.__name__ = name
        bound.__doc__ = fn.__doc__
        return bound


class _PlotNamespace:
    """Plotting verbs under sys.plot."""

    __slots__ = ('_sys',)

    def __init__(self, system):
        self._sys = system

    def layout_2d(self, **kwargs):
        """2D system layout with per-field ray fans."""
        from .plotting import layout
        return layout(self._sys, **kwargs)

    def spots(self, *, fields=None, wavelengths=None, sampling=None,
              epd=None, reference='centroid', **kwargs):
        """Spot-diagram grid over fields and wavelengths."""
        from .analysis import spot_diagrams
        from .plotting import plot_spots
        grid = spot_diagrams(self._sys, fields, wavelengths,
                             sampling=sampling, epd=epd,
                             reference=reference)
        return plot_spots(grid, **kwargs)

    def ray_fans(self, *, fields=None, wavelengths=None, nrays=21,
                 epd=None, distribution='uniform', reference='chief',
                 **kwargs):
        """Transverse ray-aberration fan grid."""
        from .analysis import ray_aberration_fans
        from .plotting import plot_ray_fans
        grid = ray_aberration_fans(self._sys, fields, wavelengths,
                                   nrays=nrays, epd=epd,
                                   distribution=distribution,
                                   reference=reference)
        return plot_ray_fans(grid, **kwargs)

    def opd_fans(self, *, fields=None, wavelengths=None, nrays=21,
                 epd=None, distribution='uniform', stop_index=None,
                 output='waves', **kwargs):
        """OPD fan grid."""
        from .analysis import opd_fans
        from .plotting import plot_opd_fans
        grid = opd_fans(self._sys, fields, wavelengths, nrays=nrays,
                        epd=epd, distribution=distribution,
                        stop_index=stop_index, output=output)
        return plot_opd_fans(grid, **kwargs)

    def field_curvature(self, *, fields=None, wavelength=None,
                        samples=101, **kwargs):
        """S/T field-curvature plot."""
        from .plotting import plot_field_curvature
        return plot_field_curvature(self._sys, fields, wavelength,
                                    samples=samples, **kwargs)

    def distortion(self, *, fields=None, wavelength=None, epd=None,
                   samples=101, distortion_type='f-tan', **kwargs):
        """Percent-distortion plot."""
        from .plotting import plot_distortion
        return plot_distortion(self._sys, fields, wavelength, epd=epd,
                               samples=samples,
                               distortion_type=distortion_type, **kwargs)

    def chromatic_focal_shift(self, *, wavelengths=None, samples=101,
                              focus='best', epd=None, **kwargs):
        """Chromatic focal-shift plot."""
        from .plotting import plot_chromatic_focal_shift
        return plot_chromatic_focal_shift(self._sys, wavelengths,
                                          samples=samples, focus=focus,
                                          epd=epd, **kwargs)

    def lateral_color(self, *, fields=None, wavelengths=None, epd=None,
                      samples=101, **kwargs):
        """Lateral-color plot."""
        from .plotting import plot_lateral_color
        return plot_lateral_color(self._sys, fields, wavelengths,
                                  epd=epd, samples=samples, **kwargs)

    def full_field(self, *, metric='rms spot', samples=15, max_field=None,
                   wavelengths=None, sampling=None, epd=None,
                   stop_index=None, **kwargs):
        """Full-field metric map."""
        from .analysis import full_field
        from .plotting import plot_full_field
        grid = full_field(self._sys, metric, samples=samples,
                          max_field=max_field, wavelengths=wavelengths,
                          sampling=sampling, epd=epd,
                          stop_index=stop_index)
        return plot_full_field(grid, **kwargs)


class _TolNamespace:
    """Tolerancing verbs under sys.tol."""

    __slots__ = ('_sys',)

    def __init__(self, system):
        self._sys = system

    def sensitivity(self, perturbations, merit, *, step=None):
        """Centered finite-difference scalar-merit sensitivity table."""
        from .tolerance import sensitivity_table
        return sensitivity_table(self._sys, perturbations, merit, step=step)

    def monte_carlo(self, perturbations, merit, n_trials, **kwargs):
        """Monte Carlo sampling of a scalar merit over perturbations."""
        from .tolerance import monte_carlo
        return monte_carlo(self._sys, perturbations, merit, n_trials,
                           **kwargs)

    def wavefront(self, perturbations, P, S, wavelength=None, **kwargs):
        """Wavefront differential (Code V TOR) for one launch bundle."""
        from .wavefront_differential import wavefront_differential
        return wavefront_differential(
            self._sys, perturbations, P, S,
            self._sys.wavelength(wavelength), **kwargs)

    def inverse_sensitivity(self, J, budget, **kwargs):
        """Per-tolerance steps that fit a sensitivity Jacobian to a budget."""
        from .adjoint.tolerance_analysis import inverse_sensitivity
        return inverse_sensitivity(J, budget, **kwargs)

    def adjoint_sensitivity(self, perturbations, heads, P, S,
                            wavelength=None, **kwargs):
        """Exact multi-objective Jacobian over editor perturbations.

        Builds adjoint seeds from tolerance.Perturbation objects and
        assembles the M x P Jacobian with one reverse-mode pass per
        head; feed the result's .jacobian to inverse_sensitivity /
        rss_prediction for budgeting.
        """
        from .adjoint.seeds import seed_from_perturbation
        from .adjoint.tolerance_analysis import multi_objective_sensitivity
        seeds = [seed_from_perturbation(p) for p in perturbations]
        return multi_objective_sensitivity(
            self._sys, P, S, self._sys.wavelength(wavelength), seeds,
            heads, **kwargs)
