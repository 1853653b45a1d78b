"""Plain reference of the wavefront-control step and the Shack-Hartmann frame.

The OPD is a Zernike sum over a disk pupil plus the reflected wavefront
error of a deformable mirror: a lattice of actuator pokes convolved (by
FFT) with a Gaussian influence function one pitch wide (FWHM), projected
through the mirror's fold (a rotation about y, sampled bilinearly, zero
outside the grid) and doubled by the obliquity.  The step focuses the
field by matrix DFT and takes the intensity L2 loss against the
unaberrated focal image, with its gradients with respect to the actuators
and the coefficients by autograd.  The sensor multiplies the field by a
lenslet array's quadratic phase screen (each lenslet's square adds its
phase; a sample on two lenslets' edges takes both) and propagates it by
angular spectrum over the lenslets' focal length to an intensity frame.
"""
import math

import numpy as np
import torch

from . import common


def nms_to(n_max):
    """Every (n, m) with n <= n_max, m from -n to n in steps of 2, n-major."""
    return [(n, m) for n in range(n_max + 1) for m in range(-n, n + 1, 2)]


class WfcReference:
    """The step and the sensor at one precision."""

    def __init__(self, cfg, prec='f64', device=None):
        self.prec = prec = common.Precision(prec)
        self.cfg = cfg
        n = self.n = cfg['N']
        x, y, dx = common.grid(n, cfg['diameter'], device=device)
        self.dx = dx
        r, t = common.polar(x, y)
        self.amp = common.coverage(common.circle_distance(1.0, r), dx).to(prec.real)
        self.modes = common.zernike_stack(nms_to(cfg['n_max']), r, t).to(prec.real)
        self.wvl = cfg['wvl']
        self.focus = common.Focus(n, dx, cfg['fN'], cfg['focal_dx'], cfg['wvl'], cfg['efl'],
                                  prec, device)
        self._dm(x, y, device)
        with torch.no_grad():
            self.I_ref = common.intensity(self.focus(self.amp.to(prec.complex)))
        self._sensor(x, y, device)

    def _dm(self, x, y, device):
        cfg, n, prec = self.cfg, self.n, self.prec
        sep, nact = cfg['act_sep'], cfg['nact']
        fwhm = sep * self.dx
        ifn = torch.exp(-4 * math.log(2) * (x * x + y * y) / fwhm ** 2)
        self.ifn_tf = torch.fft.fft2(ifn).to(prec.complex)
        # the pokes: nact samples sep apart from n // 2 + floor(-nact / 2) sep, an
        # even count half a pitch over
        first = n // 2 + (-nact // 2) * sep + (0 if nact % 2 else sep // 2)
        self.act_index = slice(first, first + nact * sep, sep)
        rot = common.rotation_matrix(cfg['rot'])
        self.obliquity = float(rot[2, 2])
        o = (n - 1) / 2
        # the fold maps a mirror point p to R (p - o) + o in its (x, y) plane; the
        # surface is pulled from the inverse image of each output sample
        M = np.array([[rot[0, 0], rot[0, 1], o - rot[0, 0] * o - rot[0, 1] * o],
                      [rot[1, 0], rot[1, 1], o - rot[1, 0] * o - rot[1, 1] * o],
                      [0.0, 0.0, 1.0]])
        Mi = np.linalg.inv(M)
        j = torch.arange(n, dtype=torch.float64, device=device)
        rows, cols = torch.meshgrid(j, j, indexing='ij')
        w = Mi[2, 0] * cols + Mi[2, 1] * rows + Mi[2, 2]
        self.src_c = ((Mi[0, 0] * cols + Mi[0, 1] * rows + Mi[0, 2]) / w).to(prec.real)
        self.src_r = ((Mi[1, 0] * cols + Mi[1, 1] * rows + Mi[1, 2]) / w).to(prec.real)

    def _bilinear(self, img):
        n = self.n
        rr, cc = self.src_r, self.src_c
        inside = (rr >= 0) & (rr <= n - 1) & (cc >= 0) & (cc <= n - 1)
        r0, c0 = torch.floor(rr), torch.floor(cc)
        fr, fc = rr - r0, cc - c0
        r0 = r0.long().clamp(0, n - 1)
        c0 = c0.long().clamp(0, n - 1)
        r1 = (r0 + 1).clamp(0, n - 1)
        c1 = (c0 + 1).clamp(0, n - 1)
        top = img[r0, c0] * (1 - fc) + img[r0, c1] * fc
        bot = img[r1, c0] * (1 - fc) + img[r1, c1] * fc
        return torch.where(inside, top * (1 - fr) + bot * fr, torch.zeros_like(top))

    def dm_wfe(self, actuators):
        """The mirror's reflected wavefront error (nm) for (nact, nact) actuators."""
        prec = self.prec
        poke = torch.zeros((self.n, self.n), dtype=prec.real, device=actuators.device)
        poke = poke.index_put((torch.arange(self.act_index.start, self.act_index.stop,
                                            self.act_index.step, device=actuators.device)
                               [:, None],
                               torch.arange(self.act_index.start, self.act_index.stop,
                                            self.act_index.step, device=actuators.device)
                               [None, :]),
                              actuators.to(prec.real))
        spec = torch.fft.fft2(torch.fft.ifftshift(poke)) * self.ifn_tf
        surface = prec.round(torch.fft.fftshift(torch.fft.ifft2(spec)).real)
        return prec.round(self._bilinear(surface) * (2 * self.obliquity))

    def opd(self, actuators, coefs):
        """Zernike sum plus the mirror's WFE, nm."""
        zern = self.prec.round(torch.tensordot(coefs.to(self.prec.real), self.modes,
                                               dims=([0], [0])))
        return zern + self.dm_wfe(actuators)

    def loss(self, actuators, coefs):
        """Intensity L2 loss of the focused field against the unaberrated image."""
        I = common.intensity(self.focus(common.field(self.amp, self.opd(actuators, coefs),
                                                     self.wvl, self.prec)))
        return torch.sum((I - self.I_ref) ** 2)

    def step(self, actuators, coefs):
        """(loss, actuator gradient, coefficient gradient)."""
        a = actuators.detach().to(self.prec.real).requires_grad_(True)
        c = coefs.detach().to(self.prec.real).requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss(a, c)
        ga, gc = torch.autograd.grad(loss, (a, c))
        return loss.detach(), ga, gc

    def _sensor(self, x, y, device):
        cfg, n, dx = self.cfg, self.n, self.dx
        pitch = cfg['sh_samples'] * dx
        lenslets = n // cfg['sh_samples']
        efl = cfg['sh_spot'] * pitch * dx / (self.wvl / 1e3)
        # lenslet centres pitch apart about the axis, an even count shifted half a pitch
        centres = (np.arange(lenslets, dtype=np.float64) - lenslets // 2) * pitch
        if lenslets % 2 == 0:
            centres = centres + pitch / 2
        span = 2 * int(pitch / dx + 1)
        phase = torch.zeros_like(x)
        for yc in centres:
            i0 = math.ceil(n / 2) + int(yc / dx) - span // 2
            rs = slice(max(i0, 0), min(i0 + span, n))
            for xc in centres:
                j0 = math.ceil(n / 2) + int(xc / dx) - span // 2
                cs = slice(max(j0, 0), min(j0 + span, n))
                lx = x[rs, cs] - float(xc)
                ly = y[rs, cs] - float(yc)
                inside = ((torch.abs(lx) - pitch / 2) <= 0) & ((torch.abs(ly) - pitch / 2) <= 0)
                phase[rs, cs] += torch.where(inside, (lx * lx + ly * ly) / (2 * efl),
                                             torch.zeros_like(lx))
        self.screen = torch.polar(torch.ones_like(phase),
                                  (-2 * math.pi / (self.wvl / 1e3)) * phase).to(self.prec.complex)
        k = torch.fft.fftfreq(n, dx, dtype=torch.float64, device=device)
        chirp = torch.polar(torch.ones_like(k), (-math.pi * (self.wvl / 1e3) * efl) * k * k)
        self.transfer = torch.outer(chirp, chirp).to(self.prec.complex)

    @torch.no_grad()
    def sensor(self, actuators, coefs):
        """The Shack-Hartmann intensity frame (n, n)."""
        prec = self.prec
        E = common.field(self.amp, self.opd(actuators, coefs), self.wvl, prec)
        E = prec.round(E * prec.round(self.screen))
        E = torch.fft.ifft2(torch.fft.fft2(E) * prec.round(self.transfer))
        return common.intensity(E)
