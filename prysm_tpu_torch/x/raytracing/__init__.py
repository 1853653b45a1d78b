"""Differentiable sequential raytracing (Spencer & Murty) in PyTorch.

Counterpart of ``prysm_tpu/x/raytracing/__init__.py`` for the modules
ported so far: the trace kernel (raytrace / refract / reflect / status),
surface shapes, apertures, intersections, OPL modifiers, ray generation,
paraxial first-order analysis, the lens-data editor and OpticalSystem,
launch and aiming, the spot statistics of ``opt``, the batched merged
trace, and the analysis cluster: ``listings``, ``sample_rx``, ``auto``,
``aberrations`` (Seidel sums), ``parabasal`` first order, ``analysis``
(exit pupil, wavefront, fans, spots, distortion, colour, full-field
maps), forward-mode ``_diff_raytrace`` and reverse-mode ``adjoint``; the
design and tolerancing cluster: ``design`` (operands, ``Problem``,
``build_problem``), ``tolerance`` (sensitivity tables, Monte Carlo),
``wavefront_differential`` (Code V TOR style), ``field`` (pupil fields
and polarization ray tracing); ``io`` (Zemax .zmx and Code V .seq
readers and writers); and ``plotting`` (layouts and analysis plots, host
numpy and matplotlib, imported only when a function draws).  A bundle
traces as plain elementwise torch on the device of its rays and
differentiates with autograd or ``torch.func.jvp``.
"""
from .spencer_and_murty import (  # NOQA
    DEFAULT_TOL_SAG,
    SURFACE_INTERSECTION_DEFAULT_MAXITER,
    STATUS_CLIP,
    STATUS_EVANESCENT,
    STATUS_MISS,
    STATUS_NEWTON,
    STATUS_OK,
    STATUS_TIR,
    STYPE_EVAL,
    STYPE_IMG,
    STYPE_OBJ,
    STYPE_REFLECT,
    STYPE_REFRACT,
    RayStatus,
    RayTraceResult,
    decode_status,
    intersect,
    newton_raphson_solve_s,
    raytrace,
    reflect,
    refract,
    transform_to_global_coords,
    transform_to_local_coords,
    valid_mask,
)
from .surfaces import (  # NOQA
    Biconic,
    CallableShape,
    Chebyshev,
    Conic,
    EvenAsphere,
    Interaction,
    Jacobi,
    OffAxisConic,
    Plane,
    Q2D,
    Shape,
    Sphere,
    Surface,
    Toroid,
    XY,
    Zernike,
)
from .aperture import (  # NOQA
    AnnularClip,
    Aperture,
    Chamfer,
    CircularClip,
    CircularExtent,
    Flat,
    FlatBackSubstrate,
    FlatParentSubstrate,
    ParallelSubstrate,
    Seat,
    SquareCut,
    Substrate,
    SurfaceSubstrate,
    annular_aperture,
    as_aperture,
    circular_aperture,
)
from .intersections import (  # NOQA
    ray_conic_intersect,
    seeded_newton_intersect,
    ray_plane_intersect,
    ray_sphere_intersect,
)
from .paraxial import (  # NOQA
    FirstOrderProperties,
    NonAxialSystemError,
    back_focal_length,
    effective_focal_length,
    entrance_pupil_z,
    front_focal_length,
    paraxial_image_distance,
    system_matrix,
    ynu_first_order,
)
from .raygen import (  # NOQA
    clip_to_aperture,
    concat_rayfans,
    generate_collimated_hex_ray_grid,
    generate_collimated_radial_spiral_ray_grid,
    generate_collimated_ray_fan,
    generate_collimated_rect_ray_grid,
    generate_finite_ray_fan,
    split_rayfans,
)
from .lensdata import (  # NOQA
    CoordBreak,
    DesignState,
    LensData,
    SurfaceRow,
    lens_element_groups,
)
from .system import (  # NOQA
    ApertureSpec,
    FieldSet,
    OpticalSystem,
)
from .launch import (  # NOQA
    Field,
    Sampling,
    launch,
    solve_apertures,
    solve_vignetting,
)
from .opt import (  # NOQA
    aim_rays,
    eic_distance,
    geometric_psf_histogram,
    hopkins_eic_closing,
    locate_ep,
    locate_xp,
    reference_sphere_curvature,
    rms_spot_radius,
    spot_centroid,
    xp_reference_sphere,
)
from .opl import CallableOPL, LinearGrating, OPLFunc  # NOQA
from .batch import (  # NOQA
    device_wavefront_fit,
    fit_from_trace,
    merged_trace,
    unmerge,
)
from .listings import (  # NOQA
    aperture_table,
    decenter_table,
    surface_table,
)
from .parabasal import (  # NOQA
    ParabasalFirstOrder,
    first_order,
    parabasal_foci,
)
from .auto import RCPrescription, RitcheyChretien  # NOQA
from .aberrations import SeidelResult, seidel_aberrations, paraxial_trace  # NOQA
from .analysis import (  # NOQA
    DistortionResult,
    FieldCurvatureResult,
    FullFieldGrid,
    OPDFanGrid,
    RayFanGrid,
    SpotGrid,
    TraceRecord,
    chromatic_focal_shift,
    distortion,
    field_curvature,
    field_sweep,
    full_field,
    iter_trace_grid,
    lateral_color,
    opd_fans,
    ray_aberration_fans,
    resolve_exit_pupil,
    spot_diagrams,
    spot_geometric_radius,
    spot_positions,
    spot_rms_radius,
    transverse_ray_aberration,
    wavefront,
    wavefront_zernike_fit,
)
from .io import read_seq, read_zmx, write_seq, write_zmx  # NOQA
from .wavefront_differential import (  # NOQA
    WavefrontDifferential,
    cumulative_probability,
    wavefront_differential,
)
from .design import (  # NOQA
    BFL,
    Boresight,
    Distortion,
    EFL,
    FieldCurvature,
    Merit,
    ParaxialImageDistance,
    Problem,
    RayHeightAt,
    RmsSpotRadius,
    Thickness,
    TotalTrack,
    WavefrontRMS,
    ZernikeCoefficient,
    build_problem,
)
from .tolerance import (  # NOQA
    MonteCarloResult,
    Perturbation,
    SensitivityTable,
    monte_carlo,
    operand_as_merit,
    sensitivity_table,
)
from .field import (  # NOQA
    FieldTraceResult,
    PRTResult,
    PupilField,
    amplitude_apodization,
    interface_coefficients,
    pupil_field,
    pupil_field_psf,
    pupil_field_to_wavefront,
    raytrace_field,
    raytrace_prt,
    sine_space_coords,
    surface_normals_from_trace,
    unpolarized_amplitude,
)
from . import plotting  # NOQA
from .plotting import (  # NOQA
    plot_ray_paths,
    plot_optics,
    layout,
    plot_transverse_ray_aberration,
    plot_wave_aberration_fan,
    plot_spot_diagram,
    plot_field_curvature,
    plot_distortion,
    plot_chromatic_focal_shift,
    plot_lateral_color,
    plot_full_field,
    plot_ray_fans,
    plot_opd_fans,
    plot_spots,
)
from . import sample_rx  # NOQA
from . import adjoint  # NOQA

# Fraunhofer spectral lines, µm
FRAUNHOFER_LINES_UM = {
    'C': 0.6562725,
    'd': 0.5875618,
    'F': 0.4861327,
}

__all__ = [
    'FRAUNHOFER_LINES_UM', 'LensData', 'SurfaceRow', 'CoordBreak',
    'DesignState', 'lens_element_groups',
    'OpticalSystem', 'ApertureSpec', 'FieldSet', 'raytrace', 'refract',
    'reflect', 'intersect', 'newton_raphson_solve_s',
    'transform_to_global_coords', 'transform_to_local_coords',
    'Field', 'Sampling', 'launch', 'solve_apertures', 'solve_vignetting',
    'aim_rays', 'Surface', 'Shape', 'Interaction',
    'CallableShape', 'Plane', 'Sphere', 'Conic', 'OffAxisConic',
    'EvenAsphere', 'Q2D', 'Zernike', 'XY', 'Chebyshev', 'Jacobi',
    'Toroid', 'Biconic', 'circular_aperture', 'annular_aperture',
    'as_aperture', 'Aperture', 'AnnularClip', 'CircularClip',
    'CircularExtent', 'Substrate', 'SurfaceSubstrate',
    'ParallelSubstrate', 'FlatParentSubstrate', 'FlatBackSubstrate',
    'Chamfer', 'Flat', 'SquareCut', 'Seat',
    'ray_conic_intersect', 'seeded_newton_intersect',
    'ray_plane_intersect', 'ray_sphere_intersect',
    'FirstOrderProperties', 'NonAxialSystemError', 'system_matrix',
    'paraxial_image_distance', 'effective_focal_length',
    'entrance_pupil_z', 'back_focal_length', 'front_focal_length',
    'ynu_first_order', 'clip_to_aperture', 'concat_rayfans',
    'generate_collimated_hex_ray_grid',
    'generate_collimated_radial_spiral_ray_grid',
    'generate_collimated_ray_fan', 'generate_collimated_rect_ray_grid',
    'generate_finite_ray_fan', 'split_rayfans',
    'xp_reference_sphere', 'locate_ep', 'locate_xp', 'eic_distance',
    'hopkins_eic_closing', 'reference_sphere_curvature',
    'spot_centroid', 'rms_spot_radius', 'geometric_psf_histogram',
    'OPLFunc', 'LinearGrating', 'CallableOPL',
    'RayTraceResult', 'RayStatus', 'decode_status', 'valid_mask',
    'STYPE_REFLECT', 'STYPE_REFRACT', 'STYPE_EVAL', 'STYPE_OBJ',
    'STYPE_IMG', 'STATUS_OK', 'STATUS_NEWTON', 'STATUS_CLIP',
    'STATUS_MISS', 'STATUS_TIR', 'STATUS_EVANESCENT',
    'DEFAULT_TOL_SAG', 'SURFACE_INTERSECTION_DEFAULT_MAXITER',
    'device_wavefront_fit', 'fit_from_trace', 'merged_trace', 'unmerge',
    'surface_table', 'aperture_table', 'decenter_table',
    'first_order', 'parabasal_foci', 'ParabasalFirstOrder',
    'TraceRecord', 'iter_trace_grid', 'field_sweep',
    'transverse_ray_aberration', 'wavefront', 'wavefront_zernike_fit',
    'distortion', 'field_curvature', 'chromatic_focal_shift', 'lateral_color',
    'full_field', 'ray_aberration_fans', 'opd_fans', 'spot_diagrams',
    'spot_rms_radius', 'spot_geometric_radius', 'spot_positions',
    'resolve_exit_pupil', 'DistortionResult', 'FieldCurvatureResult',
    'RayFanGrid', 'OPDFanGrid', 'SpotGrid', 'FullFieldGrid',
    'RitcheyChretien', 'RCPrescription', 'SeidelResult',
    'seidel_aberrations', 'paraxial_trace', 'sample_rx', 'adjoint',
    'read_seq', 'read_zmx', 'write_seq', 'write_zmx',
    'WavefrontDifferential', 'cumulative_probability', 'wavefront_differential',
    'Merit', 'RmsSpotRadius', 'RayHeightAt', 'Boresight', 'EFL', 'BFL',
    'ParaxialImageDistance', 'TotalTrack', 'Thickness', 'WavefrontRMS',
    'ZernikeCoefficient', 'Distortion', 'FieldCurvature', 'Problem',
    'build_problem', 'Perturbation', 'SensitivityTable', 'sensitivity_table',
    'MonteCarloResult', 'monte_carlo', 'operand_as_merit',
    'pupil_field', 'pupil_field_to_wavefront', 'pupil_field_psf',
    'raytrace_field', 'raytrace_prt', 'PupilField', 'FieldTraceResult',
    'PRTResult', 'amplitude_apodization', 'sine_space_coords',
    'interface_coefficients', 'surface_normals_from_trace',
    'unpolarized_amplitude',
]
