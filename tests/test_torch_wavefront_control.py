"""The port's wavefront-control step (``steps.build_wavefront_control``) against
the same computation composed from the JAX package's functions.

Float64 on the CPU at 128^2: the 36 Zernike modes (the JAX side sums its
mode stack, as its Pallas kernel runs only on a TPU or in interpret mode),
a 6 x 6 DM 20 samples apart folded 10 degrees, the MDFT to 32^2, the
intensity loss against the unaberrated PSF and its gradients with respect
to the actuators and the coefficients (autograd against ``jax.grad``), and
the Shack-Hartmann frame (4 x 4 lenslets of 32 samples).  Bars: 1e-12
relative for the OPD, the PSF, the loss, both gradients and the frame; the
lenslet screen 1e-12; the hand-written adjoint chain of an unfolded DM
equal to autograd to 1e-13.  The JAX composition's values are read from their
record (``_jax_refs``) where it is current.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu.geometry import circle_sdf, antialias, gaussian
from prysm_tpu.polynomials import zernike_nm_seq, sum_of_2d_modes
from prysm_tpu.propagation import Wavefront, prepare_executor
from prysm_tpu.propagation.angular_spectrum import angular_spectrum_transfer_function
from prysm_tpu.x.dm import DM
from prysm_tpu.x.shack_hartmann import shack_hartmann

from prysm_tpu_torch import interop, steps
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)

N, NACT, SEP, FN = 128, 6, steps.WFC_SEP, 32
BAR = 1e-12


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


class _JaxStep:
    """The same step composed from the JAX package's functions."""

    def __init__(self):
        x, y = make_xy_grid(N, diameter=2.2)
        self.dx = 2.2 / N
        self.r, self.t = cart_to_polar(x, y)
        self.amp = antialias(circle_sdf(1.0, self.r), self.dx)
        self.dm = DM(gaussian(SEP * self.dx, x, y), Nout=N, Nact=NACT, sep=SEP, rot=steps.WFC_ROT)
        self.render = self.dm.render_fn(wfe=True)
        self.modes = zernike_nm_seq(steps.WFC_NMS, self.r, self.t)
        self.plan = prepare_executor(self.dx, (N, N), 0.25, FN, steps.WVL, steps.EFL)
        self.I0 = self.psf(jnp.zeros_like(self.r))
        n, pitch, efl = steps.sh_geometry(N)
        self.screen = shack_hartmann(pitch, n, efl, steps.WVL, x, y, shift=True)
        self.tf = angular_spectrum_transfer_function(N, steps.WVL, self.dx, efl)

    def opd(self, a, c):
        return sum_of_2d_modes(self.modes, c) + self.render(a)

    def psf(self, opd):
        wf = Wavefront.from_amp_and_phase(self.amp, opd, steps.WVL, self.dx)
        return wf.focus_dft(self.plan).intensity.data

    def loss(self, a, c):
        return jnp.sum((self.psf(self.opd(a, c)) - self.I0) ** 2)

    def sensor(self, a, c):
        E = Wavefront.from_amp_and_phase(self.amp, self.opd(a, c), steps.WVL, self.dx).data
        E = jnp.fft.ifft2(jnp.fft.fft2(E * self.screen) * self.tf)
        return jnp.abs(E) ** 2


def _jax_values(acts, coefs):
    """What the tests compare of the JAX step at the state (acts, coefs)."""
    step = _JaxStep()
    a, c = jnp.asarray(acts), jnp.asarray(coefs)
    loss, (ga, gc) = jax.value_and_grad(step.loss, argnums=(0, 1))(a, c)
    return dict(opd=step.opd(a, c), I0=step.I0, loss=float(loss), ga=ga, gc=gc,
                screen=step.screen, sensor=step.sensor(a, c), ifn=step.dm.ifn, r=step.r,
                t=step.t, amp=step.amp, dx=step.dx)


@pytest.fixture(scope='module')
def jax_step():
    coefs, acts = steps.wfc_state(NACT)
    return types.SimpleNamespace(**jax_ref('step', _jax_values, acts, coefs, bar=BAR))


@pytest.fixture
def port_step():
    return steps.build_wavefront_control(N, nact=NACT, fN=FN, dtype=torch.float64,
                                         device='cpu')


def test_state_and_geometry(port_step):
    coefs, acts = steps.wfc_state(NACT)
    assert len(steps.WFC_NMS) == 36 and max(n for n, _ in steps.WFC_NMS) == 7
    assert coefs.shape == (36,) and acts.shape == (NACT, NACT)
    np.testing.assert_array_equal(port_step.pupil.coefs.numpy(), coefs)
    np.testing.assert_array_equal(port_step.dm.actuators.numpy(), acts)
    n, pitch, efl = steps.sh_geometry(1024)
    assert n == 32 and pitch == pytest.approx(32 * 2.2 / 1024)
    # each spot's first zero 4 samples out, the lenslet phase's steepest step pi / 4
    assert steps.WVL / 1e3 * efl / pitch == pytest.approx(4 * 2.2 / 1024)
    assert 2 * np.pi / (steps.WVL / 1e3) * (pitch / 2) / efl * (2.2 / 1024) == pytest.approx(
        np.pi / 4)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'mode-stack'])
def test_step_matches_jax(jax_step, fused):
    w = steps.build_wavefront_control(N, nact=NACT, fN=FN, fused=fused,
                                      dtype=torch.float64, device='cpu')
    assert _rel(w.opd(w.dm.actuators, w.pupil.coefs), jax_step.opd) <= BAR
    assert _rel(w.I_ref, jax_step.I0) <= BAR
    loss, ga, gc = w(w.dm.actuators, w.pupil.coefs)
    jl, jga, jgc = jax_step.loss, jax_step.ga, jax_step.gc
    assert float(loss) == pytest.approx(float(jl), rel=BAR)
    assert _rel(ga, jga) <= BAR and _rel(gc, jgc) <= BAR
    assert ga.shape == (NACT, NACT) and gc.shape == (36,)


def test_sensor_frame_matches_jax(jax_step, port_step):
    assert _rel(port_step.screen, jax_step.screen) <= BAR
    frame = port_step.sensor(port_step.dm.actuators, port_step.pupil.coefs)
    assert not frame.requires_grad and frame.shape == (N, N)
    assert _rel(frame, jax_step.sensor) <= BAR


def test_carried_dm_and_pupil_match_jax(jax_step):
    """``interop.dm_from_numpy`` and ``pupil_from_numpy`` carry the JAX package's state in."""
    coefs, acts = steps.wfc_state(NACT)
    dm = interop.dm_from_numpy(np.asarray(jax_step.ifn), N, NACT, SEP, rot=steps.WFC_ROT,
                               actuators=acts, device='cpu')
    pupil = interop.pupil_from_numpy(np.asarray(jax_step.r), np.asarray(jax_step.t),
                                     np.asarray(jax_step.amp), jax_step.dx, coefs, steps.WFC_NMS,
                                     device='cpu')
    w = steps.build_wavefront_control(N, nact=NACT, fN=FN, pupil=pupil, dm=dm,
                                      device='cpu')
    loss, ga, gc = w(dm.actuators, pupil.coefs)
    jl, jga, jgc = jax_step.loss, jax_step.ga, jax_step.gc
    assert float(loss) == pytest.approx(float(jl), rel=BAR)
    assert _rel(ga, jga) <= BAR and _rel(gc, jgc) <= BAR


def test_render_adjoint_chain(port_step):
    """The hand-written chain, DM.render_adjoint of the OPD cotangent, against autograd: equal
    for an unfolded DM; the folded DM's adjoint pulls through the inverse projection, which
    is not the gather's transpose (it leaves out the projection's Jacobian, cos 10 degrees)."""
    from prysm_tpu_torch.x.dm import DM as TDM
    a, c = port_step.dm.actuators, port_step.pupil.coefs

    def chain(w):
        opd = w.opd(a, c).detach().requires_grad_(True)
        g, = torch.autograd.grad(torch.sum((w.psf(opd) - w.I_ref) ** 2), opd)
        return w.dm.render_adjoint(g)

    unfolded = TDM(port_step.dm.ifn, N, Nact=NACT, sep=SEP)
    flat = steps.build_wavefront_control(N, nact=NACT, fN=FN, pupil=port_step.pupil,
                                         dm=unfolded, device='cpu')
    assert _rel(chain(flat), flat(a, c)[1]) <= 1e-13
    folded = _rel(chain(port_step), port_step(a, c)[1])
    assert 0.5 * (1 - np.cos(np.radians(10))) < folded < 2 * (1 - np.cos(np.radians(10)))


def test_f32_step_on_cast_grids_stays_near_f64():
    """The float32 step (the card's path, here on the CPU) from the float64 step's state."""
    w64 = steps.build_wavefront_control(N, nact=NACT, fN=FN, dtype=torch.float64,
                                        device='cpu')
    p = w64.pupil
    p32 = dataclasses.replace(p, r=p.r.float(), t=p.t.float(), amp=p.amp.float(),
                              coefs=p.coefs.float())
    w32 = steps.build_wavefront_control(N, nact=NACT, fN=FN, pupil=p32,
                                        dtype=torch.float32, device='cpu')
    out32, out64 = w32(w32.dm.actuators, p32.coefs), w64(w64.dm.actuators, p.coefs)
    assert all(x.dtype == torch.float32 for x in out32)
    for x, y in zip(out32, out64):
        assert _rel(x.double(), y) <= 1e-4
    f32 = w32.sensor(w32.dm.actuators, p32.coefs)
    assert f32.dtype == torch.float32 and _rel(f32.double(), w64.sensor(w64.dm.actuators,
                                                                           p.coefs)) <= 1e-5
