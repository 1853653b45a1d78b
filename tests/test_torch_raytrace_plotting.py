"""x/raytracing/plotting: the port draws what the JAX package draws.

Every case draws the same system, trace or analysis result with both
packages into Agg figures (the builders of
``tests/test_raytracing_plotting_depth.py``, written once for either
package) and compares what was plotted: each line's x/y data and label,
each collection's offsets, coordinates and image array, the axes' labels
and titles, and the warnings raised, at 1e-10 of each array's largest
magnitude (NaN separators where the JAX package has them).  Last, the port's
raytracing and parallel packages import with matplotlib blocked.
"""
import importlib
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use('Agg')

from matplotlib import pyplot as plt  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ('prysm_tpu', 'prysm_tpu_torch')


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    import jax
    from prysm_tpu_torch.conf import config
    jax.config.update('jax_enable_x64', True)
    monkeypatch.setattr(config, '_device', 'cpu')
    monkeypatch.setattr(config, '_precision', torch.float64)


def _package(pkg):
    mod = lambda name: importlib.import_module(f'{pkg}.x.{name}')  # noqa: E731
    rt = mod('raytracing')
    return SimpleNamespace(
        rt=rt, mat=mod('materials'), plotting=mod('raytracing.plotting'),
        surfaces=mod('raytracing.surfaces'), aperture=mod('raytracing.aperture'),
        snm=mod('raytracing.spencer_and_murty'), analysis=mod('raytracing.analysis'))


# ---------- builders (tests/test_raytracing_plotting_depth.py's, for either package) --------

def drawn_only(m, rim, bore=None):
    if rim is None:
        return None
    return m.aperture.Aperture(extent=m.aperture.CircularExtent(rim, inner_radius=bore or 0.0))


def flat(m, z, *, n=1.0, rim=1, bore=None, kind='refr', **kw):
    return m.surfaces.Surface(shape=m.surfaces.Plane(), interaction=kind, material=(
        None if kind == 'refl' else m.mat.ConstantMaterial(n)),
        P=np.asarray([0., 0., z]), aperture=drawn_only(m, rim, bore), **kw)


def featured(m, feature, z=0, n=1.5, rim=1):
    s = flat(m, z, n=n, rim=rim)
    s.aperture = m.aperture.Aperture(extent=m.aperture.CircularExtent(rim), features=(feature,))
    return s


def synthetic_trace(m, prescription):
    """A 3-ray vertical fan 'landing' at each surface's vertex z."""
    zs = [prescription[0].P[2] - 1] + [s.P[2] for s in prescription]
    hist = np.asarray([[[0., h, z] for h in (-1., 0., 1.)] for z in zs])
    return m.snm.RayTraceResult(hist, np.zeros_like(hist), np.zeros(hist.shape[:-1]),
                                np.zeros(3, dtype=np.complex128))


def result_of(m, hist, status):
    return m.snm.RayTraceResult(hist, np.zeros_like(hist), np.zeros(hist.shape[:-1]),
                                np.asarray(status))


def biconvex(m):
    """Constant-index biconvex singlet with a 3-point field set, image distance solved."""
    rows = m.rt.LensData()
    glass = m.mat.ConstantMaterial(1.5)
    rows.add(m.surfaces.Conic(1 / 60.0, 0.0), thickness=4.0, material=glass, aperture=8.0)
    rows.add(m.surfaces.Conic(-1 / 60.0, 0.0), thickness=95.0, material=m.mat.air, aperture=8.0)
    built = m.rt.OpticalSystem(rows, aperture=10.0, fields=[0.0, 3.0, 5.0],
                               wavelengths=[0.5876], reference=0)
    built.solve.image_distance()
    return built


def achromat(m):
    """A cemented doublet of two model glasses at three wavelengths (chromatic verbs)."""
    rows = m.rt.LensData()
    rows.add(m.surfaces.Sphere(1 / 62.0), thickness=6.0,
             material=m.mat.model_glass(1.5168, 64.17, name='BK7ish'))
    rows.add(m.surfaces.Sphere(-1 / 45.0), thickness=3.0,
             material=m.mat.model_glass(1.6727, 32.2, name='SF5ish'))
    rows.add(m.surfaces.Sphere(-1 / 128.0), thickness=95.0, material=m.mat.air)
    return m.rt.OpticalSystem(rows, aperture=m.rt.ApertureSpec.epd(20.0),
                              fields=[0.0, 1.0, 2.0], wavelengths=[0.4861, 0.5876, 0.6563],
                              reference=1, stop_index=1)


def stop_system(m):
    rows = m.rt.LensData()
    rows.add(m.surfaces.Plane(), thickness=5.0, material=m.mat.air, aperture=5.0)
    rows.add(m.surfaces.Conic(1 / 60.0, 0.0), thickness=4.0,
             material=m.mat.ConstantMaterial(1.5), aperture=8.0)
    rows.add(m.surfaces.Conic(-1 / 60.0, 0.0), thickness=95.0, material=m.mat.air,
             aperture=8.0)
    rows.add(m.surfaces.Plane(), typ='eval', material=m.mat.air, aperture=20.0)
    return m.rt.OpticalSystem(rows, aperture=8.0, fields=[0.0], wavelengths=[0.5876],
                              reference=0, stop_index=0)


def mirror(m, substrate=None, *, rim=1, bore=None, shape=None, **kw):
    return m.surfaces.Surface(
        shape=shape or m.surfaces.Plane(), interaction='refl',
        aperture=m.aperture.Aperture(
            extent=m.aperture.CircularExtent(rim, inner_radius=bore or 0.0), substrate=substrate),
        **kw)


def bare_conic(m, c, z, material, rim=None):
    return m.surfaces.Surface(shape=m.surfaces.Conic(c, 0.0), interaction='refr',
                              P=np.asarray([0., 0., z]), material=material,
                              aperture=drawn_only(m, rim))


def traced_optics(m):
    """plot_optics of a system with its own trace, in the xz view."""
    system = biconvex(m)
    P, S = m.rt.launch(system, system.field(1), 0.5876, m.rt.Sampling.hex(2))
    run = m.rt.raytrace(system.to_surfaces(), P, S, 0.5876)
    return m.plotting.plot_optics(system, run, x='z', y='x', points=21)


def _optics(m, presc, **kwargs):
    kwargs.setdefault('wvl', 0.55)
    kwargs.setdefault('points', 5)
    return m.plotting.plot_optics(presc, synthetic_trace(m, presc), **kwargs)


def _outline(m, surf, run=None, **kw):
    run = synthetic_trace(m, [surf]) if run is None else run
    xy = m.plotting.mirror_substrate_outline(surf, run, substrate=surf.aperture.substrate, **kw)
    return tuple(np.asarray(v, dtype=float) for v in xy)


FAN_HISTORY = np.asarray([[[0., -1., 0.], [0., 0., 0.], [0., 1., 0.]],
                          [[0., 9., 1.], [0., 10., 1.], [0., 12., 1.]]])
FAILED_RAYS = np.asarray([[[0., r, z] for r in (0., 1., 2.)] for z in (0., 1., 2.)])
SPOT_HISTORY = np.asarray([[[0., -1., 0.], [0., 0., 0.], [0., 1., 0.]],
                           [[2., 3., 5.], [0., 1., 5.], [-2., -1., 5.]]])


def _features(m):
    ap = m.aperture
    return {'squarecut': ap.SquareCut(0.5, 1.5, 0.25, side='upper'),
            'flat': ap.Flat(0.5, 1.5, 0.25, side='upper'),
            'chamfer': ap.Chamfer(0.5, 1.0, 0.2, side='upper'),
            'seat': ap.Seat('front', 0.5, 0.2, side='upper')}


CASES = {
    # plot_optics: lens outlines, ODs, bores, rim features, dummies, stops, bridges
    'optics_square_od': lambda m: _optics(m, [flat(m, 0, n=1.5), flat(m, 2)]),
    'optics_paired_od': lambda m: _optics(m, [flat(m, 0, n=1.5, rim=1), flat(m, 2, rim=1.5)]),
    'optics_bore': lambda m: _optics(m, [flat(m, 0, n=1.5, bore=0.5), flat(m, 2, bore=0.5)]),
    **{f'optics_feature_{name}': (lambda m, name=name: _optics(
        m, [featured(m, _features(m)[name]), flat(m, 2)]))
       for name in ('squarecut', 'flat', 'chamfer', 'seat')},
    'optics_lone_dummy': lambda m: _optics(
        m, [flat(m, z, n=n) for z, n in enumerate((1.5, 1.0, 1.0, 1.6, 1.0))]),
    'optics_stop_on_dummy': lambda m: _optics(
        m, [flat(m, z, n=n) for z, n in enumerate((1.5, 1.0, 1.0, 1.6, 1.0))], stop_index=2),
    'optics_group_od': lambda m: _optics(
        m, [flat(m, 0, n=1.5, rim=1.0), flat(m, 1, n=1.6, rim=2.0), flat(m, 2, rim=1.2)]),
    'optics_steep_bridge': lambda m: _optics(
        m, [bare_conic(m, 1 / 5.0, 0.0, m.mat.ConstantMaterial(1.5)),
            bare_conic(m, 1 / 0.5, 1.0, m.mat.air)], points=41),
    'optics_clear_aperture_land': lambda m: _optics(
        m, [bare_conic(m, 1 / 50.0, 0.0, m.mat.ConstantMaterial(1.5), rim=1.0),
            bare_conic(m, -1 / 50.0, 1.0, m.mat.air, rim=3.0)], points=41),
    'optics_mirror_face': lambda m: _optics(m, [flat(m, 0, kind='refl')]),
    'optics_mirror_parallel_substrate': lambda m: _optics(m, [mirror(
        m, m.aperture.ParallelSubstrate(thickness=2, side=1), P=np.asarray([0., 0., 0.]))]),
    'optics_traced_system_xz': lambda m: traced_optics(m),
    # mirror substrates
    'mirror_decenter': lambda m: _outline(m, mirror(
        m, m.aperture.ParallelSubstrate(thickness=2, side=1), P=np.asarray([0., 10., 5.])),
        points=5),
    'mirror_bore': lambda m: _outline(m, mirror(
        m, m.aperture.FlatParentSubstrate(thickness=5.0, side=1),
        shape=m.surfaces.Conic(1 / 200.0, 0.0), rim=10.0, bore=3.0,
        P=np.asarray([0., 0., 0.])), points=41),
    'mirror_center_on_rays': lambda m: _outline(
        m, mirror(m, m.aperture.ParallelSubstrate(thickness=2, side=1),
                  P=np.asarray([0., 0., 0.])),
        result_of(m, np.asarray([[[0., h, z] for h in (9., 10., 11.)] for z in (-1., 0.)]),
                  np.zeros(3, dtype=np.complex128)), center='rays', points=5),
    'mirror_tilt_xz': lambda m: _outline(m, mirror(
        m, m.aperture.ParallelSubstrate(thickness=2, side=1), P=np.asarray([0., 0., 0.]),
        R=(0, -45, 0)), points=5, x='z', y='x'),
    'mirror_flat_parent': lambda m: _outline(m, mirror(
        m, m.aperture.FlatParentSubstrate(thickness=2, side=1),
        shape=m.surfaces.OffAxisConic(c=1 / 100., k=-1., dy=10), rim=5,
        P=np.asarray([0., 0., 0.])), points=5),
    'mirror_flat_back': lambda m: _outline(m, mirror(
        m, m.aperture.FlatBackSubstrate(thickness=2, side=1),
        shape=m.surfaces.OffAxisConic(c=1 / 100., k=-1., dy=10), rim=5,
        P=np.asarray([0., 0., 0.])), points=5),
    'mirror_surface_plot': lambda m: m.plotting.plot_mirror_surface(mirror(
        m, shape=m.surfaces.Conic(1 / 200.0, 0.0), rim=10.0, bore=3.0,
        P=np.asarray([0., 2., 1.])), synthetic_trace(m, [flat(m, 0)]), points=21),
    'mirror_substrate_plot': lambda m: m.plotting.plot_mirror_substrate(
        mirror(m, P=np.asarray([0., 0., 0.])), synthetic_trace(m, [flat(m, 0)]),
        substrate=m.aperture.FlatBackSubstrate(thickness=2, side=1), points=9),
    # ray paths, fans, spots
    'ray_paths_failed_rays': lambda m: m.plotting.plot_ray_paths(
        result_of(m, FAILED_RAYS, [2 + 0j, 1 + 2j, 1 - 1j])),
    'transverse_fan_history': lambda m: m.plotting.plot_transverse_ray_aberration(
        FAN_HISTORY, axis='y'),
    'transverse_fan_status': lambda m: m.plotting.plot_transverse_ray_aberration(
        result_of(m, FAN_HISTORY, [1 + 2j, 0j, 0j]), axis='y'),
    'wave_fan_nm': lambda m: m.plotting.plot_wave_aberration_fan(
        np.asarray([-1., 0., 1.]), np.asarray([-0.001, 0., 0.001]), units='nm', detrend=False),
    'wave_fan_detrend': lambda m: m.plotting.plot_wave_aberration_fan(
        np.asarray([-1., 0., 1.]), np.asarray([-0.25, 0.25, 0.875]), wavelength=1),
    'spot_result_masks': lambda m: m.plotting.plot_spot_diagram(
        result_of(m, SPOT_HISTORY, [0j, 0j, 1 + 2j])),
    'spot_centroid': lambda m: m.plotting.plot_spot_diagram(
        np.asarray([[[0., 0., 0.], [0., 0., 0.]], [[1., 3., 5.], [3., 5., 5.]]]),
        origin='centroid'),
    'spot_explicit_origin': lambda m: m.plotting.plot_spot_diagram(
        np.asarray([[[0., 0., 0.], [0., 0., 0.]], [[1., 3., 5.], [3., 5., 5.]]]),
        origin=(1., 3.)),
    'spot_diagrams_grid': lambda m: m.plotting.plot_spot_diagrams(
        m.analysis.spot_diagrams(achromat(m), sampling=m.rt.Sampling.hex(3)), ncols=2),
    # field sweeps
    'field_curvature': lambda m: m.plotting.plot_field_curvature(
        biconvex(m), biconvex(m).fields, label='d'),
    'field_curvature_skew': lambda m: m.plotting.plot_field_curvature(
        biconvex(m), [m.rt.Field(1.0, 1.0, unit='deg'), m.rt.Field(2.0, 3.0, unit='deg')],
        label='d'),
    'chromatic_focal_shift': lambda m: m.plotting.plot_chromatic_focal_shift(
        biconvex(m), focus='paraxial', samples=9, label='paraxial'),
    'distortion': lambda m: m.plotting.plot_distortion(biconvex(m), biconvex(m).fields),
    'lateral_color': lambda m: m.plotting.plot_lateral_color(achromat(m), samples=5),
    'full_field': lambda m: m.plotting.plot_full_field(m.analysis.full_field(
        achromat(m), 'rms spot', samples=3, sampling=m.rt.Sampling.hex(2))),
    # every system.plot verb
    'verb_layout_2d': lambda m: stop_system(m).plot.layout_2d(),
    'verb_spots': lambda m: achromat(m).plot.spots(sampling=m.rt.Sampling.hex(3)),
    'verb_ray_fans': lambda m: achromat(m).plot.ray_fans(nrays=7),
    'verb_opd_fans': lambda m: achromat(m).plot.opd_fans(nrays=7),
    'verb_field_curvature': lambda m: biconvex(m).plot.field_curvature(samples=5),
    'verb_distortion': lambda m: biconvex(m).plot.distortion(samples=5),
    'verb_chromatic_focal_shift': lambda m: achromat(m).plot.chromatic_focal_shift(
        samples=5, focus='paraxial'),
    'verb_lateral_color': lambda m: achromat(m).plot.lateral_color(samples=5),
    'verb_full_field': lambda m: achromat(m).plot.full_field(
        samples=3, sampling=m.rt.Sampling.hex(2)),
}


def _figure(drawn):
    """The figure of what a case drew: (fig, ax[s]) pairs, or outline arrays (None)."""
    if isinstance(drawn, tuple) and hasattr(drawn[0], 'axes'):
        return drawn[0]
    return None


def _plotted(fig):
    """Everything a figure plots, as (kind, labels, arrays) records in draw order."""
    records = []
    for ax in fig.axes:
        records.append(('axes', (ax.get_xlabel(), ax.get_ylabel(), ax.get_title(),
                                 ax.get_visible()), ()))
        for ln in ax.lines:
            records.append(('line', (ln.get_label(),),
                            (np.asarray(ln.get_xdata(), dtype=float),
                             np.asarray(ln.get_ydata(), dtype=float))))
        for col in ax.collections:
            arrays = [np.asarray(col.get_offsets(), dtype=float)]
            if col.get_array() is not None:
                arrays.append(np.ma.filled(np.asarray(col.get_array(), dtype=float), np.nan))
            if hasattr(col, 'get_coordinates'):
                arrays.append(np.asarray(col.get_coordinates(), dtype=float))
            records.append(('collection', (type(col).__name__, col.get_label()), tuple(arrays)))
    return records


def _draw(pkg, case):
    m = _package(pkg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        drawn = CASES[case](m)
    fig = _figure(drawn)
    try:
        data = _plotted(fig) if fig is not None else [('outline', (), drawn)]
    finally:
        plt.close('all')
    messages = sorted(str(w.message) for w in caught if issubclass(w.category, UserWarning))
    return data, messages


def _same_arrays(got, want, what):
    assert got.shape == want.shape, what
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * max(scale, 1e-300),
                               equal_nan=True, err_msg=what)


@pytest.mark.parametrize('case', sorted(CASES))
def test_port_plots_what_the_jax_package_plots(case):
    want, want_warnings = _draw('prysm_tpu', case)
    got, got_warnings = _draw('prysm_tpu_torch', case)
    assert got_warnings == want_warnings
    assert len(got) == len(want), [r[:2] for r in got]
    for k, ((kind, labels, arrays), (kind0, labels0, arrays0)) in enumerate(zip(got, want)):
        assert (kind, labels) == (kind0, labels0), k
        assert len(arrays) == len(arrays0)
        for a, b in zip(arrays, arrays0):
            _same_arrays(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                         f'{case}: record {k} ({kind} {labels})')


def test_every_system_plot_verb_is_covered():
    verbs = {name for name in vars(_package('prysm_tpu_torch').rt.OpticalSystem(
        _package('prysm_tpu_torch').rt.LensData()).plot.__class__) if not name.startswith('_')}
    assert verbs == {case.removeprefix('verb_') for case in CASES if case.startswith('verb_')}


def test_imports_without_matplotlib():
    """x/raytracing (with plotting) and parallel import with matplotlib blocked."""
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import prysm_tpu_torch.x.raytracing as rt, prysm_tpu_torch.parallel; "
            "assert callable(rt.plotting.plot_optics) and 'jax' not in sys.modules")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)
