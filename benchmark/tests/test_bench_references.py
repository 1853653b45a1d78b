"""Each plain reference against the port at small sizes on the CPU: the same inputs give
the same answers, to float32 rounding (the port) against float64 (the reference)."""
import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference.common import peak_error

DEV = torch.device('cpu')


@pytest.fixture(scope='module')
def lowfs():
    cfg, mod = spec.config('lowfs_example')
    cfg = {**cfg, 'N': 64, 'fN': 16}
    from benchmark.reference.lowfs_example import LowfsReference
    return mod.program(cfg, DEV), LowfsReference(cfg, 'f64', DEV)


@pytest.mark.parametrize('seed', [1, 2**33 + 1])
def test_lowfs_frame_and_estimate(lowfs, seed):
    eng, ref = lowfs
    c = torch.as_tensor(np.random.default_rng(seed).uniform(-3, 3, 6), dtype=torch.float32)
    frame = eng.frame(c)
    want = ref.frame(c.double())
    assert peak_error(frame, want) < 1e-5
    assert float(torch.max(torch.abs(eng.estimate(frame).double() - ref.estimate(want)))) < 1e-4


@pytest.fixture(scope='module')
def wfc():
    cfg, mod = spec.config('wfc1024')
    cfg = {**cfg, 'N': 128, 'nact': 6, 'fN': 32}
    from benchmark.reference.wfc1024 import WfcReference
    return cfg, mod, mod.program(cfg, 5, DEV), WfcReference(cfg, 'f64', DEV)


def test_wfc_step(wfc):
    cfg, mod, eng, ref = wfc
    c, a = mod.state(cfg, 5)
    at = torch.as_tensor(a, dtype=torch.float32)
    ct = torch.as_tensor(c, dtype=torch.float32)
    loss, ga, gc = eng.step(at, ct)
    L, GA, GC = ref.step(at.double(), ct.double())
    assert abs(float(loss) - float(L)) / float(L) < 1e-4
    assert peak_error(ga, GA) < 1e-4
    assert peak_error(gc, GC) < 1e-4


def test_wfc_dm_alone(wfc):
    cfg, mod, eng, ref = wfc
    dm, act = eng.probes['dm']
    got = dm.render_fn(wfe=True)(act)
    assert peak_error(got, ref.dm_wfe(act.double())) < 1e-5


def test_wfc_sensor(wfc):
    cfg, mod, eng, ref = wfc
    c, a = mod.state(cfg, 5)
    at = torch.as_tensor(a, dtype=torch.float32)
    ct = torch.as_tensor(c, dtype=torch.float32)
    assert peak_error(eng.sensor(at, ct), ref.sensor(at.double(), ct.double())) < 1e-5


def test_broadband_serial_against_reference():
    """The sharded loss's serial form (``broadband_psf``, which each rank runs on its
    shards) against the reference's whole problem."""
    from prysm_tpu_torch.coordinates import cart_to_polar, make_xy_grid
    from prysm_tpu_torch.geometry import antialias, circle_sdf
    from prysm_tpu_torch.parallel import plan_mdft_spectral
    from prysm_tpu_torch.parallel.sharding import broadband_psf
    from prysm_tpu_torch.polynomials import zernike_nm_seq
    from benchmark.reference.broadband1024 import BroadbandReference
    cfg, mod = spec.config('broadband1024')
    cfg = {**cfg, 'N': 64, 'fN': 16, 'wvl_per_chip': 2}
    wl = mod.wavelengths(cfg)
    truth, start = mod.state(cfg, 9)
    I_meas = mod.measured(cfg, wl, truth, DEV)
    N, dx = cfg['N'], cfg['diameter'] / cfg['N']
    x, y = make_xy_grid(N, diameter=cfg['diameter'], device=DEV)
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    modes = zernike_nm_seq([tuple(m) for m in cfg['modes']], r, t)
    plan = plan_mdft_spectral(dx, (N, N), cfg['focal_dx'], cfg['fN'], wl, cfg['efl'], device=DEV)
    c = torch.as_tensor(start, dtype=torch.float32).requires_grad_(True)
    w = torch.full((len(wl),), 1.0 / len(wl))
    loss = torch.sum((broadband_psf(c, amp, modes, torch.as_tensor(wl, dtype=torch.float32), w,
                                    plan) - I_meas) ** 2)
    grad, = torch.autograd.grad(loss, c)
    L, G = BroadbandReference(cfg, wl, 'f64', DEV).step(c.detach().double(), I_meas)
    assert abs(float(loss) - float(L)) / float(L) < 1e-4
    assert peak_error(grad, G) < 1e-4
