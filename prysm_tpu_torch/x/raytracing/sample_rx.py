"""Sample prescriptions for tests and notebooks.

Counterpart of ``prysm_tpu/x/raytracing/sample_rx.py``.  The numeric
prescriptions are published design data (the fish-eye is Smith, *Modern
Lens Design* ch. 14 p. 411); the builders return fresh LensData editors
so callers can mutate freely.
"""
from ..materials import FormulaMaterial, model_glass, air
from ..materials.formulas import sellmeier
from .system import OpticalSystem, ApertureSpec, FieldSet
from .launch import Field
from .lensdata import LensData
from .surfaces import Sphere, Conic, Plane

# Schott Sellmeier coefficients for the doublet glasses
N_BK7 = FormulaMaterial(
    'N-BK7', sellmeier,
    [[1.039612120, 0.231792344, 1.010469450],
     [0.006000699, 0.0200179144, 103.56065300]])
N_SF5 = FormulaMaterial(
    'N-SF5', sellmeier,
    [[1.524818890, 0.187085527, 1.427290150],
     [0.011254756, 0.0588995392, 129.14167500]])


def doublet(rear_semidiameter=12.0):
    """75 mm EFL f/3.4 crown-flint pair; stop on a front dummy plane."""
    lens = LensData()
    lens.add(Plane(), typ='eval', thickness=10)   # front padding (cosmetic)
    lens.add(Plane(), typ='eval', thickness=0)    # the aperture stop
    lens.add(Sphere(1 / 46.44), thickness=7, material=N_BK7, aperture=12)
    lens.add(Sphere(-1 / 33.77), thickness=2.5, material=N_SF5, aperture=12)
    lens.add(Sphere(-1 / 95.94), thickness=0, material=air,
             aperture=rear_semidiameter)
    return lens


def doublet_conic(rear_semidiameter=12.0):
    """The doublet on conic surfaces, so conic constants are DOFs."""
    lens = LensData()
    lens.add(Plane(), typ='eval', thickness=10)
    lens.add(Plane(), typ='eval', thickness=0)
    lens.add(Conic(1 / 46.44, 0.), thickness=7, material=N_BK7, aperture=12)
    lens.add(Conic(-1 / 33.77, 0.), thickness=2.5, material=N_SF5,
             aperture=12)
    lens.add(Conic(-1 / 95.94, 0.), thickness=0, material=air,
             aperture=rear_semidiameter)
    return lens


def fold_mirror(tilt=(0.0, 0.0, 45.0)):
    """Flat fold: 20 mm air path, ben break, mirror, image up the fold."""
    lens = LensData()
    lens.add(Plane(), typ='refr', material=air, thickness=20.0)
    lens.add_coordbreak(tilt=tilt, kind='ben')
    lens.add(Plane(), typ='refl', thickness=15.0)
    return lens


def decentered_singlet(dy=2.0):
    """Biconvex singlet decentered dy between rev-coupled breaks."""
    lens = LensData()
    lens.add(Plane(), typ='eval', thickness=5.0)
    lens.add_coordbreak(decenter=(0.0, dy, 0.0), kind='basic')
    lens.add(Sphere(1 / 40.0), thickness=5.0, material=N_BK7, aperture=12)
    lens.add(Sphere(-1 / 40.0), thickness=0.0, material=air, aperture=12)
    lens.add_coordbreak(decenter=(0.0, dy, 0.0), kind='rev')
    lens.add(Plane(), typ='eval', thickness=60.0, aperture=20.0)
    return lens


# compiled index of the stop plane in fisheye(); OBJECT is 0
FISHEYE_STOP_INDEX = 10

# fish-eye rows: (curvature, thickness, (nd, Vd) or None, aperture or None)
_FISHEYE_ROWS = (
    (1 / 599.38300, 35.030, (1.5168, 64.17), 448.40),
    (1 / 235.82500, 190.161, None, None),
    (1 / 605.51300, 30.025, (1.4875, 70.41), None),
    (1 / 111.09400, 120.102, None, None),
    (-1 / 452.38400, 10.008, (1.4875, 70.41), None),
    (1 / 127.73300, 45.038, (1.7847, 26.10), None),
    (1 / 462.89200, 25.021, None, None),
    (0.0, 15.013, (1.5182, 58.98), None),
    (0.0, 36.281, None, None),
    (0.0, 13.762, None, None),                       # aperture stop
    (1 / 38507.64900, 10.008, (1.7847, 26.10), None),
    (1 / 95.08100, 110.093, (1.7440, 44.72), None),
    (-1 / 162.63800, 130.110, None, None),
    (1 / 1376.16700, 20.017, (1.7847, 26.10), None),
    (1 / 177.27500, 150.127, (1.7020, 41.00), 139.00),
    (-1 / 400.33900, 18.766, (1.6676, 41.93), 139.00),
    (-1 / 337.53600, 150.059, None, 139.00),
)


def fisheye():
    """Smith MLD ch.14 p.411 f/8 170-degree fish-eye.

    The manufacturer glasses are inlined as model-glass (nd, Vd)
    stand-ins so the design carries no AGF dependency.
    """
    lens = LensData()
    for c, t, glass, ap in _FISHEYE_ROWS:
        mat = air if glass is None else model_glass(*glass)
        shape = Plane() if c == 0.0 else Sphere(c)
        lens.add(shape, thickness=t, material=mat, aperture=ap)
    return lens


def fisheye_system(fields=(0.0, 30.0, 50.0),
                   wavelengths=(0.6562725, 0.5875618, 0.4861327)):
    """The fish-eye as an f/8 OpticalSystem at robust teaching fields."""
    sys = OpticalSystem(
        fisheye(),
        aperture=ApertureSpec.fno(8),
        fields=FieldSet([Field(0, h, unit='deg') for h in fields]),
        wavelengths=list(wavelengths),
        reference=1,
        stop_index=FISHEYE_STOP_INDEX,
    )
    sys.solve.image_distance()
    return sys


__all__ = [
    'N_BK7', 'N_SF5',
    'doublet', 'doublet_conic', 'fold_mirror', 'decentered_singlet',
    'fisheye', 'fisheye_system', 'FISHEYE_STOP_INDEX',
]
