"""The port's thinlens and thinfilm modules against the JAX package's.

Every function on the same inputs under ``jax_enable_x64`` with
``config.precision = 64`` and the CPU asked for.  Bar: 1e-12 relative.
Plain-arithmetic thinlens relations must keep Python floats Python floats,
as the JAX package does; the thin-film stacks run s and p, one and many
layers, trailing broadcast dimensions, and angles beyond the critical
angle (total internal reflection, the complex square-root branch).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import thinfilm as jtf, thinlens as jtl

from prysm_tpu_torch import thinfilm as ttf, thinlens as ttl
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _close(a, b, rtol=1e-12):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * max(np.abs(b).max(), 1e-300), (err, np.abs(b).max())


# (function, arguments): relations written as plain arithmetic in both packages
PLAIN = [
    ('object_to_image_dist', (50.0, -200.0)), ('image_to_object_dist', (50.0, 80.0)),
    ('object_image_to_efl', (-200.0, 66.0)), ('efl_to_power', (50.0, 1.5)),
    ('power_to_efl', (0.02,)), ('efl_to_fno', (-50.0, 10.0)), ('fno_to_efl', (4.0, 12.5)),
    ('fno_to_epd', (4.0, -50.0)), ('fno_to_na', (2.8,)), ('na_to_fno', (0.125,)),
    ('object_dist_to_mag', (50.0, -150.0)), ('mag_to_object_dist', (50.0, -0.5)),
    ('mag_to_image_dist', (50.0, -0.5)), ('linear_to_long_mag', (-0.5,)),
    ('mag_to_fno', (-0.5, 4.0, 0.8)), ('defocus_to_image_displacement', (0.25, 4.0)),
    ('defocus_to_image_displacement', (0.25, 4.0, 0.55)),
    ('image_displacement_to_defocus', (0.1, 4.0)),
    ('image_displacement_to_defocus', (0.1, 4.0, 0.55)), ('image_shift_to_tilt', (0.01, 4.0)),
    ('tilt_to_image_shift', (0.5, 4.0)), ('twolens_separation', (50.0, 80.0, 40.0)),
]


@pytest.mark.parametrize('name,args', PLAIN, ids=[f'{n}{len(a)}' for n, a in PLAIN])
def test_plain_relations_keep_python_floats(name, args):
    got, ref = getattr(ttl, name)(*args), getattr(jtl, name)(*args)
    assert type(got) is type(ref) is float
    assert got == ref


# relations through the ABCD matrices or jnp, on scalars and on arrays
MATRIX = [
    ('singlet_power', (1 / 50, -1 / 80, 4.0, 1.5168)),
    ('singlet_efl', (1 / 50, -1 / 80, 4.0, 1.5168)),
    ('singlet_bfl', (1 / 50, -1 / 80, 4.0, 1.5168, 1.33)),
    ('singlet_ffl', (1 / 50, -1 / 80, 4.0, 1.5168)),
    ('twolens_efl', (50.0, -80.0, 10.0)), ('twolens_power', (50.0, -80.0, 10.0)),
    ('twolens_bfl', (50.0, -80.0, 10.0)), ('twolens_ffl', (50.0, -80.0, 10.0)),
    ('image_dist_epd_to_na', (60.0, 12.0)), ('image_dist_epd_to_fno', (60.0, 12.0)),
]


@pytest.mark.parametrize('name,args', MATRIX, ids=[m[0] for m in MATRIX])
def test_matrix_relations(name, args):
    _close(getattr(ttl, name)(*args), getattr(jtl, name)(*args))
    # the first argument as an array: the relation broadcasts
    first = np.linspace(0.5, 1.5, 5) * args[0]
    _close(getattr(ttl, name)(torch.from_numpy(first), *args[1:]),
           getattr(jtl, name)(jnp.asarray(first), *args[1:]))


def test_matrix_relations_differentiate():
    t = torch.tensor(4.0, dtype=torch.float64, requires_grad=True)
    ttl.singlet_efl(1 / 50, -1 / 80, t, 1.5168).backward()
    assert torch.isfinite(t.grad)


def test_interface_angles():
    n1 = np.linspace(1.2, 2.0, 6)
    for deg in (True, False):
        _close(ttf.brewsters_angle(1.0, torch.from_numpy(n1), deg),
               jtf.brewsters_angle(1.0, jnp.asarray(n1), deg))
        _close(ttf.critical_angle(1.5, 1.0, deg), jtf.critical_angle(1.5, 1.0, deg))
    theta = np.linspace(0, 80, 9)
    _close(ttf.snell_aor(1.5, 1.0, torch.from_numpy(theta)),
           jtf.snell_aor(1.5, 1.0, jnp.asarray(theta)))
    _close(ttf.snell_aor(1.0, 1.5, np.radians(30.0), deg=False),
           jtf.snell_aor(1.0, 1.5, np.radians(30.0), deg=False))


@pytest.mark.parametrize('name', ['fresnel_rs', 'fresnel_ts', 'fresnel_rp', 'fresnel_tp'])
def test_fresnel_coefficients(name):
    t0 = np.radians(np.linspace(0, 85, 12))
    t1 = np.asarray(jtf.snell_aor(1.0, 1.52, t0, deg=False))
    _close(getattr(ttf, name)(1.0, 1.52, torch.from_numpy(t0), torch.from_numpy(t1)),
           getattr(jtf, name)(1.0, 1.52, jnp.asarray(t0), jnp.asarray(t1)))
    # beyond the critical angle the refracted angle is complex
    t0 = np.radians(np.linspace(50, 85, 5))
    t1 = np.asarray(jtf.snell_aor(1.52, 1.0, t0, deg=False))
    assert np.iscomplexobj(t1)
    _close(getattr(ttf, name)(1.52, 1.0, torch.from_numpy(t0), torch.from_numpy(t1)),
           getattr(jtf, name)(1.52, 1.0, jnp.asarray(t0), jnp.asarray(t1)))


def test_cos_snell_branch_beyond_the_critical_angle():
    theta = np.radians(np.linspace(0, 89, 40))
    got = ttf._cos_snell(1.52, 1.0, torch.from_numpy(theta))
    ref = jtf._cos_snell(1.52, 1.0, jnp.asarray(theta))
    _close(got, ref)
    assert (got.imag < 0).any()  # the TIR sign flip is taken
    cplx = np.sin(theta) * (1.0 + 0.01j)
    _close(ttf._cos_snell(1.0, 1.0, torch.from_numpy(np.arcsin(cplx))),
           jtf._cos_snell(1.0, 1.0, jnp.arcsin(jnp.asarray(cplx))))


QW = 0.55 / 4


@pytest.mark.parametrize('pol', ['s', 'p', 'S'])
@pytest.mark.parametrize('layers', [1, 9])
def test_multilayer_stack_trailing_dims(pol, layers):
    n = np.where(np.arange(layers) % 2 == 0, 2.35, 1.46)
    d = QW / n
    wvl = np.linspace(0.45, 0.7, 7)[:, None]
    aoi = np.linspace(0, 60, 5)[None, :]
    got = ttf.multilayer_stack_rt(n, d, torch.from_numpy(wvl), pol, 1.52, torch.from_numpy(aoi))
    ref = jtf.multilayer_stack_rt(jnp.asarray(n), jnp.asarray(d), jnp.asarray(wvl), pol, 1.52,
                                  jnp.asarray(aoi))
    for a, b in zip(got, ref):
        assert a.shape == (7, 5)
        _close(a, b)


def test_multilayer_stack_layer_maps_and_lossy_index():
    # per-pixel thicknesses: the layer axis leads, a (4, 6) map trails
    rng = np.random.default_rng(0)
    n = np.array([2.1 + 0.01j, 1.45, 2.1 + 0.01j])[:, None, None] * np.ones((3, 4, 6))
    d = rng.uniform(0.05, 0.2, (3, 4, 6))
    for pol in ('s', 'p'):
        got = ttf.multilayer_stack_rt(torch.from_numpy(n), torch.from_numpy(d), 0.6, pol, 1.5, 20.0)
        ref = jtf.multilayer_stack_rt(jnp.asarray(n), jnp.asarray(d), 0.6, pol, 1.5, 20.0)
        for a, b in zip(got, ref):
            _close(a, b)


@pytest.mark.parametrize('pol', ['s', 'p'])
def test_multilayer_stack_beyond_the_critical_angle(pol):
    # a glass ambient (1.6) over a low-index film and substrate: TIR past ~66 deg
    aoi = np.linspace(0, 85, 18)
    got = ttf.multilayer_stack_rt([1.38, 1.9], [0.1, 0.07], 0.55, pol, 1.46, torch.from_numpy(aoi),
                                  ambient_index=1.6)
    ref = jtf.multilayer_stack_rt(jnp.asarray([1.38, 1.9]), jnp.asarray([0.1, 0.07]), 0.55, pol,
                                  1.46, jnp.asarray(aoi), ambient_index=1.6)
    for a, b in zip(got, ref):
        _close(a, b)
    assert np.abs(np.abs(got[0].numpy()[-1]) - 1) < 1e-12  # total reflection


def test_multilayer_stack_rejects_bad_input():
    with pytest.raises(ValueError, match='polarization'):
        ttf.multilayer_stack_rt([1.5], [0.1], 0.5, 'x', 1.5)
    with pytest.raises(ValueError, match='at least one'):
        ttf.multilayer_stack_rt(torch.zeros(0), torch.zeros(0), 0.5, 's', 1.5)


def test_multilayer_stack_differentiates_in_thickness():
    d = torch.tensor([0.06, 0.09], dtype=torch.float64, requires_grad=True)
    r, _ = ttf.multilayer_stack_rt([2.35, 1.46], d, 0.55, 's', 1.52)
    (r.abs() ** 2).backward()
    assert torch.isfinite(d.grad).all() and (d.grad != 0).any()
