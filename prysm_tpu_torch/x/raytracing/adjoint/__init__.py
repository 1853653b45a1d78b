"""Adjoint (reverse-mode) trace sensitivities.

Counterpart of ``prysm_tpu/x/raytracing/adjoint/``: reverse mode is
autograd through the same trace kernel the nominal path runs; the seed
vocabulary and the tolerance-analysis linear algebra keep the JAX
package's public API.
"""
from .seeds import (  # NOQA
    DiffSeed,
    seed_curvature,
    seed_conic,
    seed_shape_param,
    seed_decenter,
    seed_despace,
    seed_tilt,
    seed_index,
    seed_irregularity,
    seed_from_slot,
    seed_from_perturbation,
    seeds_from_perturbations,
)
from .primitives import (  # NOQA
    adj_transform_local,
    adj_transform_global,
    adj_intersect,
    adj_refract,
    adj_reflect,
    adj_diffract,
    adj_opl_segment,
    adj_eic_closing,
    adj_eic_closing_full,
    adj_closest_point_on_axis,
)
from .engine import (  # NOQA
    adjoint_gradient,
    adjoint_gradient_multi,
    apply_seeds,
    RmsSpotHead,
    BoresightHead,
    OplSpreadHead,
    RayHeightHead,
)
from .tolerance_analysis import (  # NOQA
    AdjointResult,
    multi_objective_sensitivity,
    ToleranceSensitivityTable,
    inverse_sensitivity,
    multi_objective_budget,
    rss_prediction,
    compensated_jacobian,
)
