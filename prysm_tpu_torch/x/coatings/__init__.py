"""Thin-film coating analysis and synthesis.

Counterpart of ``prysm_tpu/x/coatings``, with the same public names:
transfer-matrix stack engine with internal fields, autograd merit
gradients, L-BFGS-B / DLS refinement, needle synthesis, deposition
monitoring, and rugate synthesis.
"""
from .stack import (  # NOQA
    Stack,
    stack_characteristic_matrices,
    forward_products,
    backward_products,
    internal_fields,
    field_at_depth,
    RTA,
    stack_rt,
)
from .diff import (  # NOQA
    forward_eval,
    thickness_gradient,
    index_gradient,
)
from .merit import (  # NOQA
    Reflectance,
    Transmittance,
    LayerAbsorptance,
    FieldIntensityAtBoundary,
    PeakFieldAtInterfaces,
    FieldInLayer,
    MeritFunction,
    as_merit,
)
from .problem import CoatingProblem  # NOQA
from .refine import refine, CoatingResult  # NOQA
from .needle import (  # NOQA
    needle_function,
    insert_needle,
    cleanup,
    synthesize,
    NeedleResult,
)
from .monitoring import (  # NOQA
    monitoring_trace,
    turning_points,
    level_cut,
    cutoff_levels,
    simulate_run,
    monitoring_error_sensitivity,
    choose_monitor_wavelength,
)
from . import common_materials  # NOQA
from .rugate import (  # NOQA
    quintic_taper,
    discretize_profile,
    rugate_period,
    notch_wavelength,
    sinusoidal_rugate,
    apodize,
    rugate_from_target,
)
from . import plotting  # NOQA
from .plotting import (  # NOQA
    plot_spectrum,
    plot_index_profile,
    plot_field_intensity,
    plot_admittance,
    plot_monitoring_trace,
)
