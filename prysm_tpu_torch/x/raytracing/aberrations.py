"""Third-order Seidel and primary chromatic aberrations.

Counterpart of ``prysm_tpu/x/raytracing/aberrations.py``.  Design: the
paraxial marginal/chief rays are traced into a struct-of-arrays
(:class:`ParaxialTrace` — one numpy vector per quantity across surfaces)
and the classical Seidel surface sums evaluate fully vectorized over the
surface axis, including the rotationally-symmetric fourth-order aspheric
contributions and the primary axial/lateral color sums.
"""
import numpy as np

from .spencer_and_murty import STYPE_REFRACT, STYPE_REFLECT
from .paraxial import (_first_order_surfaces, _paraxial_curvature,
                       entrance_pupil_z, local_vertex_curvatures)
from ._meta import object_space_index
from ._resolve import compiled_surfaces, trace_context

# microns of wavelength per one system length unit (waves conversion)
_MICRONS_PER_UNIT = {'m': 1e6, 'cm': 1e4, 'mm': 1e3, 'um': 1.0,
                     'nm': 1e-3, 'micron': 1.0, 'microns': 1.0,
                     'in': 25400.0, 'inch': 25400.0}


class ParaxialTrace:
    """Struct-of-arrays paraxial ray history: one vector per quantity.

    Attributes are numpy arrays over the surface axis: ``y`` (height),
    ``u_in``/``u_out`` (real slopes before/after), ``n_in``/``n_out``
    (signed indices), ``c`` (vertex curvature); ``shapes`` is the parallel
    list of surface shape objects.
    """

    def __init__(self, y, u_in, u_out, n_in, n_out, c, shapes):
        self.y, self.u_in, self.u_out = y, u_in, u_out
        self.n_in, self.n_out, self.c = n_in, n_out, c
        self.shapes = shapes

    def __len__(self):
        return self.y.size


def paraxial_trace(system, y0, theta0, wvl, n_ambient):
    """Trace one paraxial ray in real-slope coordinates.

    theta is the real ray slope (not the reduced angle n*theta);
    reflections flip the running index (n' = -n).  Returns a
    :class:`ParaxialTrace`.
    """
    surfaces = _first_order_surfaces(compiled_surfaces(system))
    count = len(surfaces)
    columns = {k: np.zeros(count) for k in
               ('y', 'u_in', 'u_out', 'n_in', 'n_out', 'c')}
    shapes = []

    n, y, u = float(n_ambient), float(y0), float(theta0)
    z_prev = float(surfaces[0].P[2])
    for k, surf in enumerate(surfaces):
        z_here = float(surf.P[2])
        if k:
            y += (z_here - z_prev) * u
        c = _paraxial_curvature(surf)
        if surf.typ == STYPE_REFRACT:
            n_next = float(surf.material.n(wvl))
            u_next = (n * u - y * (n_next - n) * c) / n_next
        elif surf.typ == STYPE_REFLECT:
            n_next = -n
            u_next = (n * u - y * (n_next - n) * c) / n_next
        else:
            n_next, u_next = n, u
        for name, value in (('y', y), ('u_in', u), ('u_out', u_next),
                            ('n_in', n), ('n_out', n_next), ('c', c)):
            columns[name][k] = value
        shapes.append(getattr(surf, 'shape', None))
        n, u, z_prev = n_next, u_next, z_here
    return ParaxialTrace(shapes=shapes, **columns)


def _assert_rotational_third_order_geometry(surfaces):
    _first_order_surfaces(surfaces)
    for idx, surf in enumerate(surfaces):
        if surf.typ not in (STYPE_REFLECT, STYPE_REFRACT):
            continue
        c_x, c_y = local_vertex_curvatures(surf)
        if abs(c_x - c_y) > 1e-12 * max(1.0, abs(c_x), abs(c_y)):
            raise ValueError(
                'Seidel sums are defined for centered rotational surfaces '
                f'only; surface {idx} has unequal local x/y vertex '
                'curvatures.')


def _signed_index_columns(surfaces, wvl, n_ambient):
    """(n_before, n_after) arrays; mirrors flip the running sign."""
    before, after = [], []
    n = float(n_ambient)
    for surf in surfaces:
        before.append(n)
        if surf.typ == STYPE_REFRACT:
            n = float(surf.material.n(wvl))
        elif surf.typ == STYPE_REFLECT:
            n = -n
        after.append(n)
    return np.asarray(before), np.asarray(after)


def _fourth_order_asphere_term(shape):
    """Coefficient G of r^4 in the sag departure from the vertex sphere."""
    if shape is None:
        return 0.0
    params = getattr(shape, 'params', None) or {}
    conic_part = (float(params.get('k', 0.0))
                  * float(params.get('c', 0.0)) ** 3 / 8.0)
    kind = getattr(shape, 'kind', '')
    if kind in ('conic', 'off_axis_conic'):
        return conic_part
    if kind == 'even_asphere':
        coefs = params.get('coefs', ()) or ()
        return conic_part + (float(coefs[0]) if len(coefs) else 0.0)
    return 0.0


def _reduce_field(field):
    if field.kind == 'angle':
        ax, ay = field.angle_radians()
        return None, float(np.hypot(np.tan(ax), np.tan(ay))), True
    return field.object_z, float(np.hypot(field.hx, field.hy)), False


def _max_field(fields):
    def magnitude(f):
        if f.kind == 'angle':
            return float(np.hypot(*f.angle_radians()))
        return float(np.hypot(f.hx, f.hy))

    return max(fields, key=magnitude)


def _marginal_chief_launch(ctx, field):
    """Object-space (y, theta) launches for the marginal and chief rays."""
    z_ep = entrance_pupil_z(ctx.surfaces, ctx.wavelength,
                            stop_index=ctx.stop_index)
    if z_ep is None:
        raise ValueError(
            'the entrance pupil could not be located (no aperture stop, or '
            'object-space telecentric); Seidel sums need a defined chief '
            'ray.  Set stop_index on the OpticalSystem.')
    z_first = float(ctx.surfaces[0].P[2])
    half_pupil = ctx.epd / 2.0

    obj_z, field_mag, is_angle = _reduce_field(field)
    if is_angle:
        marginal = (half_pupil, 0.0)
        chief = (field_mag * (z_first - z_ep), field_mag)
    else:
        span = z_ep - obj_z
        if abs(span) < 1e-30:
            raise ValueError(
                'the object plane coincides with the entrance pupil; the '
                'paraxial marginal/chief rays are degenerate.')
        u_m = half_pupil / span
        u_c = -field_mag / span
        marginal = (u_m * (z_first - obj_z), u_m)
        chief = (field_mag + u_c * (z_first - obj_z), u_c)
    return marginal, chief


class SeidelResult:
    """Surface-by-surface Seidel (SI..SV) and chromatic (CI, CII) sums."""

    _NAMES = ('SI', 'SII', 'SIII', 'SIV', 'SV')

    def __init__(self, SI, SII, SIII, SIV, SV, CI, CII, optical_invariant,
                 wavelength, unit, field, n_image):
        self.SI, self.SII, self.SIII, self.SIV, self.SV = SI, SII, SIII, SIV, SV
        self.CI, self.CII = CI, CII
        self.optical_invariant = float(optical_invariant)
        self.wavelength = float(wavelength)
        self.unit, self.field = unit, field
        self.n_image = float(n_image)
        self.sums = {name: float(getattr(self, name).sum())
                     for name in self._NAMES}
        if CI is not None:
            self.sums['CI'] = float(CI.sum())
            self.sums['CII'] = float(CII.sum())

    def _wavelength_in_length(self):
        per_unit = _MICRONS_PER_UNIT.get(self.unit, _MICRONS_PER_UNIT['mm'])
        return self.wavelength / per_unit

    def wavefront_coefficients(self):
        """W040/W131/W222/W220/W311 totals in waves (Welford factors)."""
        waves = self._wavelength_in_length()
        s = self.sums
        return {
            'W040': 0.125 * s['SI'] / waves,
            'W131': 0.5 * s['SII'] / waves,
            'W222': 0.5 * s['SIII'] / waves,
            'W220': 0.25 * (s['SIV'] + s['SIII']) / waves,
            'W311': 0.5 * s['SV'] / waves,
        }

    def transverse_aberrations(self, n_image=None, image_slope=None):
        """TSA/TCO/TAS/SAS/PTB/DST totals, scaled by 1/(2 n' u')."""
        if image_slope is None:
            raise ValueError(
                "transverse_aberrations requires the image-space marginal "
                "slope (image_slope=...) -- u' of the paraxial marginal "
                'ray.')
        scale = 1.0 / (2.0 * (self.n_image if n_image is None else n_image)
                       * image_slope)
        s = self.sums
        return {
            'TSA': scale * s['SI'],
            'TCO': scale * 3.0 * s['SII'],
            'TAS': scale * (3.0 * s['SIII'] + s['SIV']),
            'SAS': scale * (s['SIII'] + s['SIV']),
            'PTB': scale * s['SIV'],
            'DST': scale * s['SV'],
        }

    def __repr__(self):
        names = list(self._NAMES)
        if self.CI is not None:
            names += ['CI', 'CII']
        columns = [getattr(self, nm) for nm in names]
        head = '  surf | ' + ' '.join(f'{nm:>11s}' for nm in names)
        body = ['SeidelResult', head, '  ' + '-' * (len(head) - 2)]
        for i in range(len(self.SI)):
            body.append(f'  {i:>4d} | '
                        + ' '.join(f'{float(col[i]):11.4e}' for col in columns))
        body.append('  ' + '-' * (len(head) - 2))
        body.append(f'  {"sum":>4s} | '
                    + ' '.join(f'{self.sums[nm]:11.4e}' for nm in names))
        body.append(f'  optical invariant: {self.optical_invariant:.6g}')
        return '\n'.join(body)


def _seidel_columns(marg, chief, H):
    """Vectorized classical Seidel surface contributions (SI..SV)."""
    c, y, ybar = marg.c, marg.y, chief.y
    n_in, n_out = marg.n_in, marg.n_out
    # refraction invariants A = n' i' = n i with i = u + y c
    A = n_out * (marg.u_out + y * c)
    Abar = n_out * (chief.u_out + ybar * c)
    slope_jump = marg.u_out / n_out - marg.u_in / n_in
    petzval = c * (1.0 / n_out - 1.0 / n_in)
    inv_sq_jump = 1.0 / n_out ** 2 - 1.0 / n_in ** 2

    SI = -A * A * y * slope_jump
    SII = -A * Abar * y * slope_jump
    SIII = -Abar * Abar * y * slope_jump
    SIV = -H * H * petzval
    SV = -Abar * (Abar * Abar * inv_sq_jump * y
                  - (H + Abar * y) * ybar * petzval)

    # fourth-order aspheric departures add through the eccentricity ladder
    G = np.asarray([_fourth_order_asphere_term(s) for s in marg.shapes])
    live = (G != 0.0) & (y != 0.0)
    if live.any():
        e = np.where(live, np.divide(ybar, y, out=np.zeros_like(y),
                                     where=y != 0), 0.0)
        star = np.where(live, 8.0 * G * (n_out - n_in) * y ** 4, 0.0)
        SI = SI + star
        SII = SII + star * e
        SIII = SIII + star * e * e
        SV = SV + star * e * e * e
    return SI, SII, SIII, SIV, SV, A, Abar


def seidel_aberrations(system, field=None, wvl=None, *,
                       epd=None, stop_index=None,
                       wavelengths=None, unit=None):
    """Surface-by-surface Seidel + primary chromatic sums -> SeidelResult.

    Field-dependent terms evaluate at the largest-magnitude system field
    by default; chromatic terms need two or more wavelengths.
    """
    ctx = trace_context(system, wvl, chief=True, stop_index=stop_index,
                        epd=epd)
    if ctx.epd is None:
        raise ValueError('an entrance pupil diameter (epd=...) is required')
    if field is None:
        fields = getattr(system, 'fields', None)
        if not fields:
            raise ValueError('a field (field=...) is required; the system '
                             'carries no fields to default from.')
        field = _max_field(fields)
    unit = unit or getattr(system, 'unit', None) or 'mm'
    wavelengths = (getattr(system, 'wavelengths', None)
                   if wavelengths is None else wavelengths)
    _assert_rotational_third_order_geometry(ctx.surfaces)

    (y0_m, u0_m), (y0_c, u0_c) = _marginal_chief_launch(ctx, field)
    marg = paraxial_trace(ctx.surfaces, y0_m, u0_m, ctx.wavelength,
                          ctx.n_object)
    chief = paraxial_trace(ctx.surfaces, y0_c, u0_c, ctx.wavelength,
                           ctx.n_object)

    # Lagrange invariant (constant through the system)
    H = float(ctx.n_object) * (marg.y[0] * u0_c - chief.y[0] * u0_m)
    SI, SII, SIII, SIV, SV, A, Abar = _seidel_columns(marg, chief, H)

    distinct = (set() if wavelengths is None
                else {float(w) for w in wavelengths})
    if len(distinct) >= 2:
        wl_short, wl_long = min(distinct), max(distinct)
        nb_s, na_s = _signed_index_columns(
            ctx.surfaces, wl_short, object_space_index(ctx.surfaces, wl_short))
        nb_l, na_l = _signed_index_columns(
            ctx.surfaces, wl_long, object_space_index(ctx.surfaces, wl_long))
        # mirrors are non-dispersive; only refractions contribute
        dispersion_jump = ((na_s - na_l) / marg.n_out
                           - (nb_s - nb_l) / marg.n_in)
        CI = A * marg.y * dispersion_jump
        CII = Abar * marg.y * dispersion_jump
    else:
        CI = CII = None

    return SeidelResult(SI, SII, SIII, SIV, SV, CI, CII, H, ctx.wavelength,
                        unit, field, marg.n_out[-1])


__all__ = ['SeidelResult', 'seidel_aberrations', 'paraxial_trace']
