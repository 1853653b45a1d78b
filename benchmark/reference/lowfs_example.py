"""Plain reference of the LOWFS closed loop: frames, the reconstructor and the estimates.

The sensor renders an obscured pupil (an annulus with spider vanes) at a
defocus bias plus low-order Zernike coefficients, focuses it by matrix DFT
to a small camera, and estimates the coefficients as R (I - I0), where R is
the pseudo-inverse of the intensity Jacobian at the bias point and I0 the
frame there.  Everything is formed again from the configuration: the
Jacobian analytically (dI/dc_k = 2 Re(conj(E) F[i k Z_k A])), the
pseudo-inverse by ``torch.linalg.pinv``.
"""
import math

import torch

from . import common


class LowfsReference:
    """The loop's sensor at one precision; ``frame(c)`` and ``estimate(frame)``."""

    def __init__(self, cfg, prec='f64', device=None):
        self.prec = prec = common.Precision(prec)
        n = cfg['N']
        x, y, dx = common.grid(n, cfg['diameter'], device=device)
        r, t = common.polar(x, y)
        d = torch.maximum(common.annulus_distance(cfg['obscuration'], 1.0, r),
                          -common.spider_distance(cfg['spider_vanes'], cfg['spider_width'],
                                                  x, y))
        self.amp = common.coverage(d, dx).to(prec.real)
        self.modes = common.zernike_stack([tuple(v) for v in cfg['modes']], r, t).to(prec.real)
        self.bias = (cfg['defocus_bias_nm'] * common.zernike(2, 0, r, t)).to(prec.real)
        self.wvl = cfg['wvl']
        self.focus = common.Focus(n, dx, cfg['fN'], cfg['focal_dx'], cfg['wvl'], cfg['efl'],
                                  prec, device)
        self.I0 = self.frame(torch.zeros(len(self.modes), dtype=prec.real, device=device))
        self.R = torch.linalg.pinv(self.jacobian())

    def _pupil(self, c):
        opd = self.prec.round(self.bias + torch.tensordot(c.to(self.prec.real), self.modes,
                                                          dims=([0], [0])))
        return common.field(self.amp, opd, self.wvl, self.prec)

    def frame(self, c):
        """The (fN, fN) camera frame at coefficients c (nm)."""
        return common.intensity(self.focus(self._pupil(c)))

    def jacobian(self):
        """dI/dc at the bias point, (fN * fN, K)."""
        A = self._pupil(torch.zeros(len(self.modes), dtype=self.prec.real,
                                    device=self.amp.device))
        E = self.focus(A)
        k = 2 * math.pi / (self.wvl * 1e3)
        dE = self.focus(1j * k * self.modes * A)
        cols = 2 * (E.conj() * dE).real
        return cols.reshape(len(self.modes), -1).T

    def estimate(self, frame):
        """R (frame - I0): the K coefficients the sensor reads."""
        with self.prec.matmuls():
            return self.R @ (self.prec.round(frame.to(self.prec.real)) - self.I0).reshape(-1)
