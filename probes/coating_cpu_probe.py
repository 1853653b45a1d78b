"""Rehearse the coating design's and the L-BFGS-B phase retrieval's float32 errors on the CPU.

Run from the repository root (no card needed):

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 probes/coating_cpu_probe.py [--no-retrieval]

The JAX package runs in float32 (x64 off); the float64 reference is the
port's float64 path on the CPU, which matches the JAX package's float64
path to 1e-12 (tests/test_torch_coatings_design.py,
tests/test_torch_design_paths.py).  At the chip's size it prints:

* the coating design (``steps.build_coating_design``: 41 layers, 1024
  wavelengths x 2 angles, s and p) at its perturbed start: the JAX
  package's float32 merit value, thickness gradient and index gradient
  against float64, and its float32 |R + T - 1| over the merit's grids;
* the phase retrieval (``steps.build_phase_retrieval_lbfgsb``: 1024^2
  pupil, MDFT to 256^2, 40 ``PrysmLBFGSB`` iterations from 0.8 x the truth
  in a +-60 box): the largest |coefficient - truth| of the JAX package's
  float32 run (the mode-stack OPD, f32 matmuls); of the same run with the
  MDFT's two products, and their transposes in the gradient, taking TF32's
  operands (each float32 real and imaginary part rounded to 10 mantissa
  bits, to nearest with ties away from zero, as a TF32 tensor-core GEMM
  takes them; sums in float32), the arithmetic of the card's TF32 plan; and
  of the port's float64 run for the floor the 40 iterations leave.

Each float32 bar of chip_smoke.py's phases 3j and 3k is twice the JAX
package's figure.  These are CPU numbers: they say how float32 rounding
propagates through the algorithms, not what the card does.
"""
import json
import sys
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu.geometry import circle_sdf, antialias
from prysm_tpu.polynomials import zernike_nm_seq, sum_of_2d_modes
from prysm_tpu.propagation import Wavefront, prepare_executor
from prysm_tpu.x import coatings as jc, optym as jo

from prysm_tpu_torch import steps

torch.set_num_threads(4)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def design_grids():
    """The design's (wvl, theta) grids of its R and T terms, as steps builds them."""
    return [steps._spectral_grid(band, steps.COATING_AOI)
            for band in (steps.COATING_REFLECT, steps.COATING_TRANSMIT)]


def jax_design():
    """The JAX package's float32 stack and merit of the design."""
    d = steps.build_coating_design(dtype=torch.float64, device='cpu')
    (wr, tr), (wt, tt) = design_grids()
    merit = [jc.Reflectance(wr, tr, pol='avg', target=1.0),
             jc.Transmittance(wt, tt, pol='avg', target=1.0)]
    return d, jc.Stack(d.stack0.indices, d.start, steps.COATING_SUBSTRATE), merit


def coating():
    d, stack, merit = jax_design()
    out = {}
    for variables in ('thickness', 'index'):
        f64, g64 = d.problem(variables=variables).fg(d.problem(variables=variables).x0())
        prob = jc.CoatingProblem(stack, merit, variables=variables)
        t0 = time.perf_counter()
        f32, g32 = prob.fg(prob.x0())
        print(f'  JAX f32 {variables} fg: {time.perf_counter() - t0:.1f} s', flush=True)
        assert np.asarray(g32).dtype == np.float32
        if variables == 'thickness':
            out['merit'] = abs(float(f32) - float(f64)) / abs(float(f64))
        out[f'{variables}_gradient'] = rel(g32, g64.numpy())
    energy = 0.0
    for wvl, theta in design_grids():
        for pol in 'sp':
            R, T, _ = jc.RTA(stack, jnp.asarray(wvl, jnp.float32), jnp.asarray(theta, jnp.float32),
                             pol)
            energy = max(energy, float(np.max(np.abs(np.asarray(R, np.float64)
                                                     + np.asarray(T, np.float64) - 1))))
    out['energy'] = energy
    return out


def tf32(z):
    """A complex64 array with its real and imaginary parts rounded to TF32 (10 mantissa bits)."""
    def round_part(x):
        bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
        bits = (bits + jnp.uint32(0x1000)) & jnp.uint32(0xFFFFE000)
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    return jax.lax.complex(round_part(jnp.real(z)), round_part(jnp.imag(z)))


@jax.custom_vjp
def tf32_matmul(a, b):
    """a @ b from TF32 operands, summed in float32; its transposes likewise."""
    return tf32(a) @ tf32(b)


def _tf32_fwd(a, b):
    return tf32_matmul(a, b), (a, b)


def _tf32_bwd(res, g):
    a, b = res
    return tf32(g) @ tf32(b).T, tf32(a).T @ tf32(g)


tf32_matmul.defvjp(_tf32_fwd, _tf32_bwd)


def tf32_mdft(plan):
    """The JAX plan's forward, its products taking TF32 operands (the plan's association)."""
    def apply(ary):
        Ex, Ey = plan.Ex, plan.Ey
        ary = ary.astype(Ex.dtype)
        if plan.forward_left_first:
            out = tf32_matmul(tf32_matmul(Ey, ary), Ex.T)
        else:
            out = tf32_matmul(Ey, tf32_matmul(ary, Ex.T))
        return out * plan.norm
    return apply


def jax_retrieval(N=1024, fN=256, iters=steps.RETRIEVAL_ITERS, tf32_products=False):
    """The JAX package's float32 run of the retrieval: cfg2's forward, PrysmLBFGSB."""
    x, y = make_xy_grid(N, diameter=2.2)
    r, t = cart_to_polar(x, y)
    dx = 2.2 / N
    amp = antialias(circle_sdf(1.0, r), dx)
    modes = zernike_nm_seq(steps.NMS6, r, t)
    plan = prepare_executor(dx, (N, N), 0.25, fN, steps.WVL, steps.EFL, matmul_precision='high')
    truth = jnp.asarray(steps.COEFS6, jnp.float32)

    mdft = tf32_mdft(plan)

    def intensity(c):
        wf = Wavefront.from_amp_and_phase(amp, sum_of_2d_modes(modes, c), steps.WVL, dx)
        if tf32_products:
            return jnp.abs(mdft(wf.data)) ** 2
        return wf.focus_dft(plan).intensity.data

    I_meas = intensity(truth)
    fg = jax.jit(jax.value_and_grad(lambda c: jnp.sum((intensity(c) - I_meas) ** 2)))
    bound = np.full(len(steps.COEFS6), steps.RETRIEVAL_BOUND, np.float32)
    opt = jo.PrysmLBFGSB(fg, truth * steps.RETRIEVAL_START, lower_bounds=-bound,
                         upper_bounds=bound)
    res = jo.run_until(opt, jo.MaxIterations(iters))
    assert np.asarray(res.x).dtype == np.float32
    return float(np.max(np.abs(np.asarray(res.x, np.float64) - np.asarray(steps.COEFS6))))


def port_retrieval(N=1024, fN=256):
    pr = steps.build_phase_retrieval_lbfgsb(N=N, fN=fN, matmul_precision=None,
                                            dtype=torch.float64, device='cpu')
    res = pr()
    return float((res.x - pr.truth).abs().max())


def main(argv):
    assert not jax.config.jax_enable_x64, 'the JAX package must run in float32 (x64 off)'
    out = {'coating': coating()}
    if '--no-retrieval' not in argv:
        t0 = time.perf_counter()
        out['retrieval_jax_f32'] = jax_retrieval()
        print(f'  JAX f32 retrieval: {time.perf_counter() - t0:.1f} s', flush=True)
        out['retrieval_jax_f32_tf32_products'] = jax_retrieval(tf32_products=True)
        t0 = time.perf_counter()
        out['retrieval_port_f64'] = port_retrieval()
        print(f'  port f64 retrieval: {time.perf_counter() - t0:.1f} s', flush=True)
    bars = {k: 2 * v for k, v in out['coating'].items()}
    if 'retrieval_jax_f32' in out:
        bars['retrieval'] = 2 * out['retrieval_jax_f32']
        bars['retrieval_tf32'] = 2 * out['retrieval_jax_f32_tf32_products']
    print(json.dumps({'errors': out, 'bars (2x the JAX package)': bars}, indent=1))


if __name__ == '__main__':
    main(sys.argv[1:])
