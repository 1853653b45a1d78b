"""Propagation: unitary-FFT focus (fft.py), matrix-DFT plans (dft.py), Wavefront."""
from .fft import (  # NOQA
    focus, focus_adjoint, unfocus, unfocus_adjoint,
    Q_for_sampling, pupil_sample_to_psf_sample, psf_sample_to_pupil_sample,
)
from .dft import (  # NOQA
    coordinates_for_focus, prepare_executor, unit_cell_focal_grid,
    focus_dft, focus_dft_adjoint, unfocus_dft, unfocus_dft_adjoint,
)
from .wavefront import Wavefront, phase_prefix  # NOQA
