"""RichData: a 2D array with its sample spacing and wavelength.

Counterpart of ``prysm_tpu/_richdata.py`` (the main path's part); slices
and interpolation come with a later slice of the port.
"""
import torch

__all__ = ['RichData']


class RichData:
    """2D data + sample spacing + wavelength."""

    def __init__(self, data, dx, wavelength):
        """data: 2D tensor; dx: sample spacing; wavelength: um (or None)."""
        self.data = data
        self.dx = dx
        self.wavelength = wavelength

    @property
    def shape(self):
        """Proxy to data shape."""
        return self.data.shape

    @property
    def pv(self):
        """Peak-to-valley of the finite elements."""
        finite = self.data[torch.isfinite(self.data)]
        return finite.max() - finite.min()

    @property
    def rms(self):
        """RMS of the finite elements."""
        finite = self.data[torch.isfinite(self.data)]
        return torch.sqrt(torch.mean(finite * finite))
