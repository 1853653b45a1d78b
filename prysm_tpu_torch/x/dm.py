"""Deformable mirror forward model and adjoint.

Counterpart of ``prysm_tpu/x/dm.py``.  The DM surface is influence-function
Fourier convolution of an FFT-centered poke lattice, with Fourier-domain
subpixel shift, homography rotation projection (the bilinear
``coordinates.warp``), Fourier upsampling, and pad/crop to the output grid.
The render chain is a function of the actuator array that autograd
differentiates (the actuators are written into the poke array by a slice
assignment); ``render_adjoint`` is the hand-written reverse chain.

The projection's grids are fixed once the DM is built, so a rotated DM
plans its warp then (``ops.warp.WarpPlan``): the render pulls through
``ops.warp.warp_planned``, whose forward is ``coordinates.warp``'s bit for
bit and whose backward is one gather kernel over the plan's transpose in
place of autograd's sorted scatter.

A DM works in its influence function's dtype and on its device: the
lattice, the transfer function (built once with ``torch.fft`` there), the
projection grids and the obliquity.
"""
import copy

import numpy as onp
import torch

from ..conf import config, to_tensor
from ..mathops import is_odd
from ..fttools import fourier_resample, crop_center, pad2d
from ..convolution import apply_transfer_functions
from ..coordinates import warp, apply_homography, make_rotation_matrix
from ..ops.warp import WarpPlan, warp_planned
from ..profiling import backward_span, span

__all__ = ['prepare_actuator_lattice', 'prepare_fwd_reverse_projection_coordinates', 'DM']


def prepare_actuator_lattice(shape, Nact, sep, dtype, device=None):
    """FFT-centered actuator lattice bookkeeping (host-side slices)."""
    cy, cx = [s // 2 for s in shape]
    Nactx, Nacty = Nact
    skip_samples_x, skip_samples_y = sep
    actuators = torch.zeros((Nacty, Nactx), dtype=dtype, device=device)
    offx = 0
    offy = 0
    if not is_odd(Nactx):
        offx = skip_samples_x // 2
    if not is_odd(Nacty):
        offy = skip_samples_y // 2
    neg_extreme_x = cx + -Nactx // 2 * skip_samples_x + offx
    neg_extreme_y = cy + -Nacty // 2 * skip_samples_y + offy
    pos_extreme_x = cx + Nactx // 2 * skip_samples_x + offx
    pos_extreme_y = cy + Nacty // 2 * skip_samples_y + offy
    ix = slice(neg_extreme_x, pos_extreme_x, skip_samples_x)
    iy = slice(neg_extreme_y, pos_extreme_y, skip_samples_y)
    poke_arr = torch.zeros(shape, dtype=dtype, device=device)
    return {
        'actuators': actuators,
        'poke_arr': poke_arr,
        'ixx': ix,
        'iyy': iy,
    }


def prepare_fwd_reverse_projection_coordinates(shape, rot, dtype=None, device=None):
    """Forward and reverse warp grids for a rigid-body rotation projection.

    The rotation is rounded to ``dtype`` (default ``config.precision``) before
    the homographies are formed in float64; the grids are computed in
    ``dtype`` on ``device``.
    """
    dtype = config.precision if dtype is None else dtype
    R = make_rotation_matrix(rot, host=True, dtype=dtype)
    oy, ox = [(s - 1) / 2 for s in shape]
    y = torch.arange(shape[0], dtype=dtype, device=device)
    x = torch.arange(shape[1], dtype=dtype, device=device)
    y, x = torch.meshgrid(y, x, indexing='ij')
    Tin = onp.eye(4)
    Tin[0, -1] = -ox
    Tin[1, -1] = -oy
    Tout = onp.eye(4)
    Tout[0, -1] = ox
    Tout[1, -1] = oy
    Rh = onp.zeros((4, 4))
    Rh[:3, :3] = R
    Rh[3, 3] = 1
    Mfwd = Tout @ (Rh @ Tin)
    mask = [0, 1, 3]
    Mfwd = Mfwd[mask][:, mask]
    Mifwd = onp.linalg.inv(Mfwd)
    xfwd, yfwd = apply_homography(torch.as_tensor(Mifwd, dtype=dtype, device=x.device), x, y)
    xrev, yrev = apply_homography(torch.as_tensor(Mfwd, dtype=dtype, device=x.device), x, y)
    return (xfwd, yfwd), (xrev, yrev)


class DM:
    """Rectangular-grid DM with a shared influence function.

    Parameters are those of the JAX package's ``DM`` (and prysm's): ``ifn``
    the influence function (a tensor, or a numpy array put on
    ``config.device``), ``Nout`` the output samples, ``Nact`` the actuators
    across, ``sep`` their spacing in samples, ``shift`` a subpixel shift,
    ``rot`` (Z, Y, X) Euler angles in degrees, ``upsample`` a Fourier
    resampling factor.  ``render`` is a function of ``self.actuators``: set
    them and call render, or use ``render_fn`` for a function of the
    actuators alone.
    """

    def __init__(self, ifn, Nout, Nact=50, sep=10, shift=(0, 0), rot=(0, 0, 0),
                 upsample=1, project_centering='fft'):
        """Build the poke lattice, transfer function, and projections."""
        if isinstance(Nout, int):
            Nout = (Nout, Nout)
        if isinstance(Nact, int):
            Nact = (Nact, Nact)
        if isinstance(sep, int):
            sep = (sep, sep)
        self.ifn = to_tensor(ifn)
        dtype, dev = self.ifn.dtype, self.ifn.device
        s = tuple(self.ifn.shape)
        self.Nout = Nout
        self.Nact = Nact
        self.sep = sep
        self.shift = shift
        self.obliquity = float(make_rotation_matrix(rot, host=True, dtype=dtype)[2, 2])
        self.rot = rot
        self.upsample = upsample

        out = prepare_actuator_lattice(s, Nact, sep, dtype=dtype, device=dev)
        self.actuators = out['actuators']
        self.poke_arr = out['poke_arr']
        self.ixx = out['ixx']
        self.iyy = out['iyy']

        self.needs_rot = not onp.allclose(rot, [0, 0, 0])
        if self.needs_rot:
            fwd, rev = prepare_fwd_reverse_projection_coordinates(s, rot, dtype=dtype,
                                                                  device=dev)
            self.projx, self.projy = fwd
            self.invprojx, self.invprojy = rev
            self.warp_plan = WarpPlan(self.projy, self.projx, s)
        else:
            self.projx = self.projy = None
            self.invprojx = self.invprojy = None
            self.warp_plan = None

        tf = torch.fft.fft2(self.ifn)
        if shift[0] != 0 or shift[1] != 0:
            # the ramps and the product in complex128, rounded once, as the
            # JAX package forms them in host numpy
            Y = onp.fft.fftfreq(s[0], 1)
            X = onp.fft.fftfreq(s[1], 1)
            Xramp = onp.exp(1j * (X * (-2 * onp.pi * shift[0])))
            Yramp = onp.exp(1j * (Y * (-2 * onp.pi * shift[1])))
            Xramp = torch.from_numpy(onp.broadcast_to(Xramp, s).copy()).to(dev)
            Yramp = torch.from_numpy(onp.broadcast_to(Yramp, tuple(reversed(s))).T.copy()).to(dev)
            tf = (tf.to(torch.complex128) * Xramp * Yramp).to(tf.dtype)
        self._tf = tf

    @property
    def tf(self):
        """The transfer-function chain: [fft2 of the influence function, times the shift's
        ramps]."""
        return [self._tf]

    def copy(self):
        """Make a (deep) copy of this DM."""
        return copy.deepcopy(self)

    def update(self, actuators):
        """Set the actuator commands."""
        self.actuators = to_tensor(actuators, device=self.ifn.device).reshape(
            self.actuators.shape)

    def render(self, wfe=True):
        """Render the DM surface (or reflected WFE) from self.actuators."""
        return self.render_fn(wfe)(self.actuators)

    def render_fn(self, wfe=True):
        """Function actuators -> surface, differentiable by autograd.

        Its spans: ``x.dm.render``, and ``x.dm.render.bwd`` around autograd's
        backward of it (the planned warp's and the convolution's).
        """
        def _render(actuators):
            with span('x.dm.render'):
                actuators, close = backward_span('x.dm.render.bwd', actuators)
                poke_arr = torch.zeros_like(self.poke_arr)
                poke_arr[self.iyy, self.ixx] = actuators
                sfe = apply_transfer_functions(poke_arr, None, self.tf, shift=False)
                if self.needs_rot:
                    warped = warp_planned(sfe, self.warp_plan)
                else:
                    warped = sfe
                if wfe:
                    warped = warped * (2 * self.obliquity)
                if self.upsample != 1:
                    warped = fourier_resample(warped, self.upsample)
                self.Nintermediate = warped.shape
                if warped.shape[0] < self.Nout[0]:
                    warped = pad2d(warped, out_shape=self.Nout)
                elif warped.shape[0] > self.Nout[1]:
                    warped = crop_center(warped, out_shape=self.Nout)
                return close(warped)
        return _render

    def render_adjoint(self, protograd, wfe=True):
        """Hand-written adjoint of render(): image-plane grad -> actuator grad."""
        if protograd.shape[0] > self.Nintermediate[0]:
            protograd = crop_center(protograd, out_shape=self.Nintermediate)
        elif protograd.shape[0] < self.Nintermediate[0]:
            protograd = pad2d(protograd, out_shape=self.Nintermediate)
        if self.upsample != 1:
            upsample = self.ifn.shape[0] / protograd.shape[0]
            protograd = fourier_resample(protograd, upsample)
        if wfe:
            protograd = protograd * (2 * self.obliquity)
        if self.needs_rot:
            protograd = warp(protograd, self.invprojx, self.invprojy)
        in_actuator_space = apply_transfer_functions(
            protograd, None, [torch.conj(t) for t in self.tf], shift=False)
        return in_actuator_space[self.iyy, self.ixx]
