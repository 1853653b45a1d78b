"""The port's mesh patterns (``prysm_tpu_torch.parallel``) on gloo ranks of the CPU.

Each world size (1, 2, 4, 8) is one spawn of that many ranks (a process
group over a ``file://`` rendezvous under the test's temporary directory,
with an explicit timeout); every rank runs every pattern once in float64
and sends its results back.  The patterns are held:

* against the port's serial path at 1e-12 (relative to each result's
  largest magnitude): loss, gradient and outputs.  At world sizes 2-8 this
  pins the autograd rules of the collectives: a replicated loss's gradient
  must come out once, not multiplied by the group size;
* against the JAX package's sharded functions on the 8 virtual CPU devices
  of ``conftest.py`` (meshes ``wl 2 x ty 4``, hybrid ``{'wl': 2} x
  {'ty': 4}``, ``lv 8``, ``ct 8``, ``fy 8``, ``wl 8``, ``rays 8``), from the
  same numpy inputs, at 1e-10;
* for equality across ranks (replicated results) and for their
  ``ValueError``s.

Row-sharded results come back as each rank's block; the blocks in rank
order make the JAX package's global array.  The module imports no JAX at
its top: the ranks import it to find their entry point, and import only
torch.
"""
import datetime
import os
import queue
import traceback

import numpy as np
import pytest
import torch

WORLDS = (1, 2, 4, 8)
N, W, FN, Q = 32, 4, 16, 2
W_OVERLAP = 16
COEFS = (5.0, -3.0, 2.0)
WVL, EFL = 0.55, 10.0
LEVELS = 8
SPAWN_TIMEOUT = 240


# ---------------------------------------------------------------------------
# the same numpy inputs for both packages
# ---------------------------------------------------------------------------

def _grid(n=N):
    dx = 2.2 / n
    x = (np.arange(n) - n // 2) * dx
    X, Y = np.meshgrid(x, x)
    return dx, np.hypot(X, Y), np.arctan2(Y, X)


def _amp(radius=1.0):
    dx, r, _ = _grid()
    return np.clip(0.5 - (r - radius) / dx, 0.0, 1.0)


def _modes():
    _, r, t = _grid()
    return np.stack([2 * r * r - 1, r * r * np.cos(2 * t), (3 * r ** 3 - 2 * r) * np.cos(t)])


def _wavelengths(n):
    return np.linspace(0.5, 0.6, n)


def _field():
    rng = np.random.default_rng(13)
    return rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))


def _focal_mask():
    c = np.arange(FN) - (FN - 1) / 2
    return np.exp(1j * np.arctan2(*np.meshgrid(c, c)))


def _numpy_focus(E, Q):
    M = int(np.ceil(E.shape[0] * Q))
    pad = (M - E.shape[0] + 1) // 2, (M - E.shape[0]) // 2
    padded = np.pad(E, (pad, pad))
    return np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(padded))) / M


def _fft_meas():
    return np.abs(_numpy_focus(_field(), Q)) ** 2 * 0.9


def _meshes(world):
    """The mesh of each pattern at a world size (the JAX tests' at 8)."""
    wl = 2 if world >= 2 else 1
    return {'broadband': {'wl': wl, 'ty': world // wl},
            'hybrid': ({'wl': wl}, {'ty': world // wl}),
            'multires': {'lv': world}, 'contraction': {'ct': world}, 'fft': {'fy': world},
            'overlap': {'wl': world}, 'raytrace': {'rays': world}}


def _doublet(rt, mat):
    bk7 = mat.model_glass(1.5168, 64.17, name='BK7ish')
    sf5 = mat.model_glass(1.6727, 32.2, name='SF5ish')
    lens = rt.LensData()
    lens.add(rt.Sphere(1 / 62.0), thickness=6.0, material=bk7)
    lens.add(rt.Sphere(-1 / 45.0), thickness=3.0, material=sf5)
    lens.add(rt.Sphere(-1 / 128.0), thickness=95.0, material=mat.air)
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(20.0), fields=[0.0, 1.0, 2.0],
                            wavelengths=[0.55], stop_index=1)


NMS_FIT = ((0, 0), (1, 1), (1, -1), (2, 0), (2, 2), (3, 1))
NMS_UNEVEN = ((0, 0), (2, 0), (2, 2))


# ---------------------------------------------------------------------------
# the port, on each rank
# ---------------------------------------------------------------------------

def _port_inputs():
    from prysm_tpu_torch import parallel as par
    from prysm_tpu_torch.propagation import prepare_executor, prepare_multiresolution
    from prysm_tpu_torch.propagation.coronagraph import vortex_phase_mask
    dx = 2.2 / N
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    wl = t(_wavelengths(W))
    wl16 = t(_wavelengths(W_OVERLAP))
    return {
        'coefs': t(COEFS), 'amp': t(_amp()), 'modes': t(_modes()),
        'wavelengths': wl, 'weights': torch.ones(W, dtype=torch.float64) / W,
        'plan': par.plan_mdft_spectral(dx, (N, N), 0.4, FN, _wavelengths(W), EFL),
        'wl16': wl16, 'weights16': torch.ones(W_OVERLAP, dtype=torch.float64) / W_OVERLAP,
        'plan16': par.plan_mdft_spectral(dx, (N, N), 0.4, FN, _wavelengths(W_OVERLAP), EFL),
        'a': t(_amp()).to(torch.complex128), 'lyot': t(_amp(0.9)),
        'mre': prepare_multiresolution(dx, (N, N), 0.5, 24, WVL, EFL, num_levels=LEVELS,
                                       scaling=2.0, fine_samples=24),
        'fpm': vortex_phase_mask(2),
        'mdft': prepare_executor(dx, (N, N), 0.4, FN, WVL, EFL),
        'mask': torch.as_tensor(_focal_mask()),
        'E': torch.as_tensor(_field()), 'I_fft': t(_fft_meas()),
    }


def _value_and_grad(fn, x):
    x = x.detach().requires_grad_(True)
    value = fn(x)
    grad, = torch.autograd.grad(value, x)
    return value.detach(), grad


def _overlap_fields(inp, coefs):
    from prysm_tpu_torch.mathops import cis
    opd = torch.tensordot(coefs, inp['modes'], dims=([0], [0]))
    scale = 2 * np.pi / (inp['wl16'] * 1e3)
    E = inp['plan16'](inp['amp'][None] * cis(scale[:, None, None] * opd[None]))
    return E.real ** 2 + E.imag ** 2


def _port_serial(inp):
    """The port's serial counterparts of every pattern."""
    from prysm_tpu_torch import parallel as par
    from prysm_tpu_torch.propagation import focus, unfocus
    from prysm_tpu_torch.propagation.coronagraph import to_fpm_and_back_multiresolution
    from prysm_tpu_torch.x import materials as mat
    from prysm_tpu_torch.x import raytracing as rt
    from prysm_tpu_torch.x.raytracing.batch import device_wavefront_fit, merged_trace
    c, amp, modes, wl, w, plan = (inp[k] for k in ('coefs', 'amp', 'modes', 'wavelengths',
                                                    'weights', 'plan'))
    I_meas = par.broadband_psf(c * 0.5, amp, modes, wl, w, plan)
    out = {}
    out['bb_loss'], out['bb_grad'] = _value_and_grad(
        lambda cc: torch.sum((par.broadband_psf(cc, amp, modes, wl, w, plan) - I_meas) ** 2), c)
    a, fpm, lyot = inp['a'], inp['fpm'], inp['lyot']

    def babinet(aa):
        return lyot * (aa - to_fpm_and_back_multiresolution(aa, lambda x, y: 1 - fpm(x, y),
                                                              inp['mre']))

    out['mr_roundtrip'] = to_fpm_and_back_multiresolution(a, lambda x, y: 1 - fpm(x, y),
                                                          inp['mre'])
    out['mr_babinet'] = babinet(a)
    out['mr_grad'] = _value_and_grad(lambda aa: torch.sum(babinet(aa).abs() ** 2), a)[1]
    mdft, mask = inp['mdft'], inp['mask']
    out['ct_focal'] = mdft(a)

    def roundtrip(aa):
        return mdft.adjoint(mdft(aa) * mask)

    out['ct_roundtrip'] = roundtrip(a)
    out['ct_grad'] = _value_and_grad(lambda aa: torch.sum(roundtrip(aa).abs() ** 2), a)[1]
    E, I_fft = inp['E'], inp['I_fft']
    out['focus'], out['unfocus'] = focus(E, Q), unfocus(E, Q)
    re, im = E.real.clone().requires_grad_(True), E.imag.clone().requires_grad_(True)
    F = focus(torch.complex(re, im), Q)
    loss = torch.sum((F.real ** 2 + F.imag ** 2 - I_fft) ** 2)
    out['fft_loss'] = loss.detach()
    out['fft_gre'], out['fft_gim'] = torch.autograd.grad(loss, (re, im))
    I_pw = _overlap_fields(inp, c * 0.5) * 0.9
    out['ov_loss'], out['ov_grad'] = _value_and_grad(
        lambda cc: torch.sum(inp['weights16'][:, None, None]
                             * (_overlap_fields(inp, cc) - I_pw) ** 2), c)
    system = _doublet(rt, mat)
    out['rt_coefs'], out['rt_rms'] = device_wavefront_fit(system, NMS_FIT,
                                                          sampling=rt.Sampling.hex(6))
    out['rt_uneven'], _ = device_wavefront_fit(system, NMS_UNEVEN, sampling=rt.Sampling.hex(4))
    _, (trace,) = merged_trace(system, wavelengths=[0.55], sampling=rt.Sampling.hex(8))
    out['rt_final'] = trace.P[-1].reshape(3, -1, 3)
    return out


def _port_sharded(inp, world):
    """Every pattern on this rank; replicated results whole, row-sharded ones as blocks."""
    from prysm_tpu_torch import parallel as par
    from prysm_tpu_torch.parallel.fft import (plan_distributed_focus, plan_distributed_unfocus,
                                              shard_focus_grad_step)
    from prysm_tpu_torch.parallel.overlap import overlapped_spectral_grad
    from prysm_tpu_torch.x import materials as mat
    from prysm_tpu_torch.x import raytracing as rt
    meshes = _meshes(world)
    c, amp, modes, wl, w, plan = (inp[k] for k in ('coefs', 'amp', 'modes', 'wavelengths',
                                                    'weights', 'plan'))
    I_meas = par.broadband_psf(c * 0.5, amp, modes, wl, w, plan)
    out = {}
    mesh = par.make_mesh(meshes['broadband'])
    out['bb_loss'], out['bb_grad'] = par.shard_broadband_step(mesh, plan, amp, modes, wl, w,
                                                              I_meas)(c)
    hybrid = par.make_hybrid_mesh(*meshes['hybrid'])
    out['hy_axes'] = par.mesh_axes(hybrid)
    out['hy_loss'], out['hy_grad'] = par.shard_broadband_step(hybrid, plan, amp, modes, wl, w,
                                                              I_meas)(c)

    lv = par.make_mesh(meshes['multires'])
    stacked = par.stack_multiresolution(inp['mre'], inp['fpm'], babinet=True)
    a, lyot = inp['a'], inp['lyot']
    out['mr_roundtrip'] = par.shard_multires_roundtrip(lv, stacked)(a)
    babinet = par.shard_multires_babinet(lv, stacked, lyot)
    out['mr_babinet'] = babinet(a)
    out['mr_grad'] = _value_and_grad(lambda aa: torch.sum(babinet(aa).abs() ** 2), a)[1]

    ct = par.make_mesh(meshes['contraction'])
    from prysm_tpu_torch.parallel._collectives import psum
    out['ct_focal'] = par.shard_mdft_contraction(ct, inp['mdft'])(a)
    rtrip = par.shard_mdft_contraction_roundtrip(ct, inp['mdft'], focal_factor=inp['mask'])
    out['ct_roundtrip'] = rtrip(a)
    out['ct_grad'] = _value_and_grad(
        lambda aa: psum(torch.sum(rtrip(aa).abs() ** 2), ct, 'ct'), a)[1]

    fy = par.make_mesh(meshes['fft'])
    E = inp['E']
    out['focus'] = plan_distributed_focus(fy, (N, N), Q, dtype=np.float64)(E)
    out['unfocus'] = plan_distributed_unfocus(fy, (N, N), Q, dtype=np.float64)(E)
    step = shard_focus_grad_step(fy, (N, N), Q, dtype=np.float64)
    out['fft_loss'], (out['fft_gre'], out['fft_gim']) = step(E.real, E.imag, inp['I_fft'])

    wl_mesh = par.make_mesh(meshes['overlap'])
    I_pw = _overlap_fields(inp, c * 0.5) * 0.9
    out['ov_loss'], out['ov_grad'] = overlapped_spectral_grad(
        wl_mesh, inp['plan16'], amp, modes, inp['wl16'], inp['weights16'], I_pw, n_chunks=2)(c)

    rays = par.make_mesh(meshes['raytrace'])
    system = _doublet(rt, mat)
    out['rt_coefs'], out['rt_rms'] = par.shard_wavefront_fit(rays, system, NMS_FIT,
                                                             sampling=rt.Sampling.hex(6))
    out['rt_uneven'], _ = par.shard_wavefront_fit(rays, system, NMS_UNEVEN,
                                                  sampling=rt.Sampling.hex(4))
    out['rt_landed'], out['rt_ray_surfs'] = par.shard_merged_trace_rate(
        rays, system, 0.55, rt.Sampling.hex(8))
    out['errors'] = _port_errors(world, inp)
    return out


def _message(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _port_errors(world, inp):
    """The ValueError message of each refused construction (None if it was taken)."""
    from prysm_tpu_torch import parallel as par
    from prysm_tpu_torch.parallel.fft import plan_distributed_focus
    from prysm_tpu_torch.parallel.overlap import overlapped_spectral_grad
    from prysm_tpu_torch.propagation import prepare_executor, prepare_multiresolution
    errors = {
        'mesh_size': _message(lambda: par.make_mesh({'a': world + 1})),
        'hybrid_size': _message(lambda: par.make_hybrid_mesh({'host': 3}, {'chip': 5})),
        'mesh_axis': _message(lambda: par.shard_mdft_contraction(
            par.make_mesh({'fy': world}), inp['mdft'])),
        'uniform': _message(lambda: par.stack_multiresolution(prepare_multiresolution(
            2.2 / N, (N, N), 0.5, 24, WVL, EFL, num_levels=3, scaling=2.0, fine_samples=32),
            inp['fpm'])),
    }
    if world == 1:
        solo = par.make_mesh({'fy': 1})
        errors['odd'] = _message(lambda: plan_distributed_focus(solo, (256, 255), 1))
        return errors
    levels5 = par.stack_multiresolution(prepare_multiresolution(
        2.2 / N, (N, N), 0.5, 24, WVL, EFL, num_levels=5, scaling=2.0, fine_samples=24),
        inp['fpm'], babinet=True)
    odd_rows = prepare_executor(2.2 / 17, (17, 17), 0.4, FN, WVL, EFL)
    mesh = par.make_mesh({'m': world})
    errors.update({
        'levels': _message(lambda: par.shard_multires_roundtrip(mesh, levels5, lvl_axis='m')),
        'rows': _message(lambda: par.shard_mdft_contraction(mesh, odd_rows, axis='m')),
        'fft_rows': _message(lambda: plan_distributed_focus(mesh, (2 * world + 1, 16), 1,
                                                            axis='m')),
        'chunks': _message(lambda: overlapped_spectral_grad(
            mesh, inp['plan16'], inp['amp'], inp['modes'], inp['wl16'], inp['weights16'],
            torch.zeros(W_OVERLAP, FN, FN, dtype=torch.float64), n_chunks=3, wl_axis='m')),
    })
    return errors


def _pattern_errors(world):
    """{(pattern, output): (max |sharded - serial|, max |serial|)} of this rank's
    ``steps.build_parallel_patterns`` at a small size (levels and wavelength pairs: one a
    rank at 8 ranks)."""
    from prysm_tpu_torch import steps
    steps.CFG6_RINGS, steps.PARALLEL_TRACE_RINGS = 4, 6
    steps.PARALLEL_MR = (64, 24, LEVELS)
    steps.PARALLEL_WVLS = tuple(_wavelengths(W_OVERLAP))
    errors = {}
    for name, pattern in steps.build_parallel_patterns('cpu', torch.float64, N=64,
                                                       fN=32).items():
        got, want = pattern.sharded(), pattern.serial()
        for key in want:
            errors[name, key] = (float((got[key] - want[key]).abs().max()),
                                 float(want[key].abs().max()))
    return errors


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def _rank_main(rank, world, rendezvous, results):
    """One gloo rank: every pattern, and the serial path on rank 0."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group('gloo', init_method=f'file://{rendezvous}', rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        from prysm_tpu_torch import config
        config.device = 'cpu'
        config.precision = torch.float64
        inp = _port_inputs()
        out = {'sharded': _host(_port_sharded(inp, world)), 'patterns': _pattern_errors(world)}
        if rank == 0:
            out['serial'] = _host(_port_serial(inp))
        results.put((rank, 'ok', out))
    except BaseException:  # every failure goes back to the parent, which re-raises it
        results.put((rank, 'error', traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(world, tmp):
    """{rank: results} of one spawn of ``world`` ranks; a rank's exception is raised here."""
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, os.path.join(tmp, 'rendezvous'),
                                                  results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(world):
            rank, status, payload = results.get(timeout=SPAWN_TIMEOUT)
            if status == 'ok':
                got[rank] = payload
            else:
                errors.append(f'rank {rank}:\n{payload}')
                break
    except queue.Empty:
        errors.append(f'no result within {SPAWN_TIMEOUT} s from ranks '
                      f'{sorted(set(range(world)) - set(got))}')
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError('\n'.join(errors))
    assert not any(p.is_alive() for p in procs)
    return got


@pytest.fixture(scope='module', params=WORLDS, ids=lambda w: f'world{w}')
def world(request, tmp_path_factory):
    """(world size, {rank: results}) from one spawn."""
    size = request.param
    return size, _spawn(size, str(tmp_path_factory.mktemp(f'world{size}')))


# ---------------------------------------------------------------------------
# the JAX package's sharded functions on the 8 virtual devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_results():
    import jax
    import jax.numpy as jnp
    import prysm_tpu.x.materials as jmat
    import prysm_tpu.x.raytracing as jrt
    from prysm_tpu import parallel as jpar
    from prysm_tpu.mathops import cis
    from prysm_tpu.parallel.fft import (plan_distributed_focus, plan_distributed_unfocus,
                                        shard_focus_grad_step)
    from prysm_tpu.parallel.overlap import overlapped_spectral_grad
    from prysm_tpu.propagation import prepare_executor, prepare_multiresolution
    from prysm_tpu.propagation.coronagraph import vortex_phase_mask
    jax.config.update('jax_enable_x64', True)
    if len(jax.devices()) < 8:
        pytest.fail('the JAX side needs the 8 virtual CPU devices of conftest.py')
    meshes = _meshes(8)
    dx = 2.2 / N
    c, amp, modes = jnp.asarray(COEFS), jnp.asarray(_amp()), jnp.asarray(_modes())
    wl, w = jnp.asarray(_wavelengths(W)), jnp.ones(W) / W
    plan = jpar.plan_mdft_spectral(dx, (N, N), 0.4, FN, _wavelengths(W), EFL)
    I_meas = jpar.broadband_psf(c * 0.5, amp, modes, wl, w, plan)
    out = {}
    out['bb_loss'], out['bb_grad'] = jpar.shard_broadband_step(
        jpar.make_mesh(meshes['broadband']), plan, amp, modes, wl, w, I_meas)(c)
    out['hy_loss'], out['hy_grad'] = jpar.shard_broadband_step(
        jpar.make_hybrid_mesh(*meshes['hybrid']), plan, amp, modes, wl, w, I_meas)(c)

    lv = jpar.make_mesh(meshes['multires'])
    mre = prepare_multiresolution(dx, (N, N), 0.5, 24, WVL, EFL, num_levels=LEVELS,
                                  scaling=2.0, fine_samples=24)
    stacked = jpar.stack_multiresolution(mre, vortex_phase_mask(2), babinet=True)
    a, lyot = jnp.asarray(_amp(), dtype=jnp.complex128), jnp.asarray(_amp(0.9))
    out['mr_roundtrip'] = jpar.shard_multires_roundtrip(lv, stacked)(a)
    babinet = jpar.shard_multires_babinet(lv, stacked, lyot)
    out['mr_babinet'] = babinet(a)
    # JAX's gradient of a real function of complex input is the conjugate of torch's
    out['mr_grad'] = jnp.conj(jax.grad(lambda aa: jnp.sum(jnp.abs(babinet(aa)) ** 2))(a))

    ct = jpar.make_mesh(meshes['contraction'])
    mdft = prepare_executor(dx, (N, N), 0.4, FN, WVL, EFL)
    out['ct_focal'] = jpar.shard_mdft_contraction(ct, mdft)(a)
    rtrip = jpar.shard_mdft_contraction_roundtrip(ct, mdft, focal_factor=_focal_mask())
    out['ct_roundtrip'] = rtrip(a)
    out['ct_grad'] = jnp.conj(jax.grad(lambda aa: jnp.sum(jnp.abs(rtrip(aa)) ** 2))(a))

    fy = jpar.make_mesh(meshes['fft'])
    E = _field()
    out['focus'] = plan_distributed_focus(fy, (N, N), Q, dtype=np.float64)(jnp.asarray(E))
    out['unfocus'] = plan_distributed_unfocus(fy, (N, N), Q, dtype=np.float64)(jnp.asarray(E))
    out['fft_loss'], (out['fft_gre'], out['fft_gim']) = shard_focus_grad_step(
        fy, (N, N), Q, dtype=np.float64)(jnp.asarray(E.real), jnp.asarray(E.imag),
                                         jnp.asarray(_fft_meas()))

    wl16, w16 = jnp.asarray(_wavelengths(W_OVERLAP)), jnp.ones(W_OVERLAP) / W_OVERLAP
    plan16 = jpar.plan_mdft_spectral(dx, (N, N), 0.4, FN, _wavelengths(W_OVERLAP), EFL)
    opd0 = jnp.tensordot(c * 0.5, modes, axes=(0, 0))
    E0 = plan16(amp[None] * cis((2 * jnp.pi / (wl16 * 1e3))[:, None, None] * opd0[None]))
    I_pw = (E0.real ** 2 + E0.imag ** 2) * 0.9
    out['ov_loss'], out['ov_grad'] = overlapped_spectral_grad(
        jpar.make_mesh(meshes['overlap']), plan16, amp, modes, wl16, w16, I_pw, n_chunks=2)(c)

    rays = jpar.make_mesh(meshes['raytrace'])
    system = _doublet(jrt, jmat)
    out['rt_coefs'], out['rt_rms'] = jpar.shard_wavefront_fit(rays, system, list(NMS_FIT),
                                                              sampling=jrt.Sampling.hex(6))
    out['rt_uneven'], _ = jpar.shard_wavefront_fit(rays, system, list(NMS_UNEVEN),
                                                   sampling=jrt.Sampling.hex(4))
    out['rt_landed'], out['rt_ray_surfs'] = jpar.shard_merged_trace_rate(
        rays, system, 0.55, jrt.Sampling.hex(8))
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

ROW_SHARDED = {'ct_roundtrip', 'focus', 'unfocus', 'fft_gre', 'fft_gim'}
PATTERNS = {
    'broadband': ('bb_loss', 'bb_grad'),
    'hybrid': ('hy_loss', 'hy_grad'),
    'multires': ('mr_roundtrip', 'mr_babinet', 'mr_grad'),
    'contraction': ('ct_focal', 'ct_roundtrip', 'ct_grad'),
    'fft': ('focus', 'unfocus', 'fft_loss', 'fft_gre', 'fft_gim'),
    'overlap': ('ov_loss', 'ov_grad'),
    'raytrace': ('rt_coefs', 'rt_rms', 'rt_uneven'),
}
SERIAL_KEY = {'hy_loss': 'bb_loss', 'hy_grad': 'bb_grad'}
# the wavefront fit solves its normal equations: their conditioning carries the
# reassociated ray sums (1e-16 of the largest) into the smallest coefficients as
# ~1.5e-12 of the largest; every other result meets 1e-12
SERIAL_TOL = {'rt_coefs': 1e-11, 'rt_uneven': 1e-11, 'rt_rms': 1e-11}


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), np.finfo(float).tiny)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _global(results, key):
    """A result as a whole array: rank 0's if replicated, else the blocks in rank order."""
    if key in ROW_SHARDED:
        return np.concatenate([results[r]['sharded'][key] for r in sorted(results)])
    return results[0]['sharded'][key]


@pytest.mark.parametrize('pattern', sorted(PATTERNS))
def test_sharded_equals_the_port_serial_path(world, pattern):
    """Loss, gradient and outputs at 1e-12 of the serial path; the gradient of a
    replicated loss comes out once at every world size."""
    size, results = world
    for key in PATTERNS[pattern]:
        _close(_global(results, key), results[0]['serial'][SERIAL_KEY.get(key, key)],
               SERIAL_TOL.get(key, 1e-12),
               f'{pattern} {key} at world size {size}')


@pytest.mark.parametrize('pattern', sorted(PATTERNS))
def test_sharded_equals_the_jax_package(world, jax_results, pattern):
    """Every rank count against the JAX package's sharded functions on 8 devices, at 1e-10."""
    size, results = world
    for key in PATTERNS[pattern]:
        _close(_global(results, key), jax_results[key], 1e-10,
               f'{pattern} {key} at world size {size}')


def test_replicated_results_agree_on_every_rank(world):
    size, results = world
    for key, value in results[0]['sharded'].items():
        if key in ROW_SHARDED or key == 'errors':
            continue
        for rank in range(1, size):
            np.testing.assert_array_equal(results[rank]['sharded'][key], value,
                                          err_msg=f'{key} on rank {rank}')


def test_merged_trace_rate_matches_the_jax_package(world, jax_results):
    """The landing sum over the padded bundle (pad rays copy each field's ray 0) against the
    serial trace, and at 8 ranks against the JAX package; the ray-surface count."""
    size, results = world
    got = results[0]['sharded']
    final = np.nan_to_num(results[0]['serial']['rt_final'])
    F, n = final.shape[:2]
    padded = -(-n // size) * size
    _close(got['rt_landed'], final.sum(axis=(0, 1)) + (padded - n) * final[:, 0].sum(axis=0),
           1e-12, 'landing sum against the serial trace')
    surfaces = int(jax_results['rt_ray_surfs']) // (F * -(-n // 8) * 8)
    assert got['rt_ray_surfs'] == F * padded * surfaces
    if size == 8:
        _close(got['rt_landed'], jax_results['rt_landed'], 1e-10, 'landing sum')


def test_hybrid_mesh_orders_the_slow_axis_first(world):
    assert world[1][0]['sharded']['hy_axes'] == ('wl', 'ty')


ERRORS = {
    'mesh_size': 'do not match device count', 'hybrid_size': 'hybrid mesh wants 15 devices',
    'mesh_axis': "no axis named 'ct'", 'uniform': 'uniform level shapes', 'odd': 'even sizes',
    'levels': '5 levels do not divide', 'rows': 'pupil row count 17 does not divide',
    'fft_rows': 'does not divide', 'chunks': 'does not split into 3 chunks',
}


def test_value_errors(world):
    size, results = world
    errors = results[0]['sharded']['errors']
    want = {'mesh_size', 'hybrid_size', 'mesh_axis', 'uniform'} | (
        {'odd'} if size == 1 else {'levels', 'rows', 'fft_rows', 'chunks'})
    assert set(errors) == want
    for name, message in errors.items():
        assert message is not None and ERRORS[name] in message, (name, message)


def test_chip_patterns_at_every_world_size(world):
    """``steps.build_parallel_patterns``, the chip's phase 3p, equals its serial path on every
    rank of every world size at 1e-12 of each output's largest magnitude; the fit's
    coefficients at 1e-11, as above, and its residual RMS at 1e-12 mm (the 36-mode fit of
    hex(4)'s 61 rays a field leaves a residual at the rounding floor, ~1e-19 mm)."""
    size, results = world
    for rank, out in results.items():
        assert len(out['patterns']) == 18
        for (name, key), (diff, scale) in out['patterns'].items():
            if (name, key) == ('raytrace_fit', 'rms'):
                assert diff <= 1e-12, (size, rank, name, key, diff)
                continue
            tol = SERIAL_TOL.get(f'rt_{key}', 1e-12) if name == 'raytrace_fit' else 1e-12
            assert diff <= tol * scale, (size, rank, name, key, diff / scale)


def test_mesh_size_errors_without_a_process_group():
    """The JAX messages, before any group is needed: ranks given explicitly."""
    from prysm_tpu_torch import parallel as par
    with pytest.raises(ValueError, match=r'mesh sizes \[2, 3\] do not match device count 8'):
        par.make_mesh({'wl': 2, 'ty': 3}, devices=range(8))
    with pytest.raises(ValueError, match='hybrid mesh wants 15 devices, have 8'):
        par.make_hybrid_mesh({'host': 3}, {'chip': 5}, devices=range(8))
    with pytest.raises(RuntimeError, match='init_process_group'):
        par.make_mesh({'wl': -1})


def test_stacked_multires_from_numpy_carries_the_jax_stack():
    """``interop.stacked_multires_from_numpy`` of the JAX stack's leaves equals the port's own
    stack at 1e-12, and both round-trip as the JAX package's ``multires_roundtrip`` at 1e-10;
    a real ``dtype`` picks its complex pair."""
    import jax.numpy as jnp
    from prysm_tpu import parallel as jpar
    from prysm_tpu.propagation import prepare_multiresolution as jax_prepare
    from prysm_tpu.propagation.coronagraph import vortex_phase_mask as jax_vortex
    from prysm_tpu_torch import interop
    from prysm_tpu_torch import parallel as par
    from prysm_tpu_torch.propagation import prepare_multiresolution
    from prysm_tpu_torch.propagation.coronagraph import vortex_phase_mask
    args = (2.2 / N, (N, N), 0.5, 24, WVL, EFL)
    kw = dict(num_levels=LEVELS, scaling=2.0, fine_samples=24)
    jstack = jpar.stack_multiresolution(jax_prepare(*args, **kw), jax_vortex(2), babinet=True)
    carried = interop.stacked_multires_from_numpy(
        *(np.asarray(getattr(jstack, k)) for k in ('Ex_re', 'Ex_im', 'Ey_re', 'Ey_im', 'norm',
                                                    'maskwin_re', 'maskwin_im')), device='cpu')
    mre = prepare_multiresolution(*args, **kw, dtype=torch.complex128, device='cpu')
    native = par.stack_multiresolution(mre, vortex_phase_mask(2), babinet=True)
    assert len(native) == len(carried) == LEVELS
    for name in ('Ex', 'Ey', 'norm', 'maskwin'):
        _close(getattr(native, name).numpy(), getattr(carried, name).numpy(), 1e-12, name)
    a = _amp().astype(complex)
    want = np.asarray(jpar.multires_roundtrip(jnp.asarray(a), jstack))
    for stack in (carried, native):
        _close(par.multires_roundtrip(torch.as_tensor(a), stack).numpy(), want, 1e-10,
               'multires_roundtrip')
    single = par.stack_multiresolution(mre, vortex_phase_mask(2), dtype=torch.float32)
    assert single.Ex.dtype == single.maskwin.dtype == torch.complex64
    assert single.norm.dtype == torch.float32


@pytest.fixture
def gloo_world1(tmp_path):
    """A world-size-1 gloo group in this process, destroyed after the test."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=f'file://{tmp_path / "rendezvous"}', rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('dtype, tol', [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=['f64', 'f32'])
def test_build_parallel_patterns_sharded_equals_serial(gloo_world1, monkeypatch, dtype, tol):
    """The chip's phase 3p on the CPU at a small size: every pattern of
    ``steps.build_parallel_patterns`` against its serial counterpart."""
    from prysm_tpu_torch import steps
    monkeypatch.setattr(steps, 'CFG6_RINGS', 4)
    monkeypatch.setattr(steps, 'PARALLEL_TRACE_RINGS', 6)
    monkeypatch.setattr(steps, 'PARALLEL_MR', (64, 24, 3))
    patterns = steps.build_parallel_patterns('cpu', dtype, N=64, fN=32)
    assert sorted(patterns) == ['babinet', 'broadband', 'contraction', 'fft', 'hybrid',
                                'merged_trace', 'overlap', 'raytrace_fit']
    for name, pattern in patterns.items():
        got, want = pattern.sharded(), pattern.serial()
        assert sorted(got) == sorted(want), name
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            assert got[key].real.dtype == dtype, (name, key)
            _close(got[key].numpy(), want[key].numpy(), tol, f'{name} {key}')
