"""Plain reference of the broadband phase-retrieval step, in one process.

The pupil field of each wavelength, amp exp(i 2 pi OPD / wvl), with the OPD
a sum of Zernike modes, is focused by its own matrix DFT (the focal grid is
shared, so each wavelength's frequencies scale by 1 / (wvl efl)); the
broadband image is the weighted sum of the intensities; the loss is its L2
distance to the measured image, and the gradient with respect to the
coefficients comes from autograd.  The measured image is made here too,
from the seeded truth, and handed to the program as an input.
"""
import numpy as np
import torch

from . import common


class BroadbandReference:
    """All wavelengths of the problem at one precision."""

    def __init__(self, cfg, wavelengths, prec='f64', device=None):
        self.prec = prec = common.Precision(prec)
        n = cfg['N']
        x, y, dx = common.grid(n, cfg['diameter'], device=device)
        r, t = common.polar(x, y)
        self.amp = common.coverage(common.circle_distance(1.0, r), dx).to(prec.real)
        self.modes = common.zernike_stack([tuple(v) for v in cfg['modes']], r, t).to(prec.real)
        self.wavelengths = [float(w) for w in np.asarray(wavelengths, dtype=np.float64)]
        self.weight = 1.0 / len(self.wavelengths)
        self.focus = [common.Focus(n, dx, cfg['fN'], cfg['focal_dx'], w, cfg['efl'], prec, device)
                      for w in self.wavelengths]

    def image(self, coefs):
        """The broadband focal image at coefficients (nm)."""
        opd = self.prec.round(torch.tensordot(coefs.to(self.prec.real), self.modes,
                                              dims=([0], [0])))
        out = 0
        for w, focus in zip(self.wavelengths, self.focus):
            out = out + self.weight * common.intensity(focus(common.field(self.amp, opd, w,
                                                                          self.prec)))
        return out

    def step(self, coefs, measured):
        """(loss, coefficient gradient) against the measured image."""
        c = coefs.detach().to(self.prec.real).requires_grad_(True)
        with torch.enable_grad():
            resid = self.image(c) - measured.to(self.prec.real)
            loss = torch.sum(resid * resid)
        grad, = torch.autograd.grad(loss, c)
        return loss.detach(), grad
