"""Propagation: unitary-FFT focus (fft.py), MDFT/CZT/FFTDFT plans and multi-resolution
stacks (dft.py), angular spectrum (angular_spectrum.py), coronagraphs (coronagraph.py),
Wavefront."""
from .fft import (  # NOQA
    focus, focus_adjoint, unfocus, unfocus_adjoint,
    Q_for_sampling, pupil_sample_to_psf_sample, psf_sample_to_pupil_sample,
)
from .dft import (  # NOQA
    coordinates_for_focus, prepare_executor, unit_cell_focal_grid,
    MultiResolutionExecutor, prepare_multiresolution,
    focus_dft, focus_dft_adjoint, unfocus_dft, unfocus_dft_adjoint,
)
from .angular_spectrum import (  # NOQA
    angular_spectrum, angular_spectrum_adjoint,
    angular_spectrum_transfer_function, fresnel_number, talbot_distance,
)
from .coronagraph import (  # NOQA
    to_fpm_and_back, to_fpm_and_back_adjoint, vortex_phase_mask,
    prepare_measured_fpm, to_fpm_and_back_multiresolution,
    to_fpm_and_back_multiresolution_adjoint, babinet, babinet_adjoint,
)
from .wavefront import Wavefront, phase_prefix  # NOQA
