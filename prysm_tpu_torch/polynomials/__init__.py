"""Polynomial families: Jacobi, Zernike, Chebyshev, Legendre, Hermite,
Laguerre, Dickson, Q (Forbes), XY, and the fitting and mode-sum machinery.

Counterpart of ``prysm_tpu/polynomials/__init__.py``: the same names.
"""
from .jacobi import (  # NOQA
    jacobi, jacobi_der, jacobi_seq, jacobi_der_seq,
    jacobi_with_der, jacobi_seq_with_der,
    jacobi_sum_clenshaw, jacobi_sum_clenshaw_der,
    jacobi_radial_sum, jacobi_radial_sum_der_xy, recurrence_abc,
)
from .zernike import (  # NOQA
    zernike_norm, zernike_nm, zernike_nm_seq, zernike_sum,
    zernike_nm_der, zernike_nm_der_seq,
    zernike_nm_der_xy, zernike_nm_der_xy_seq, zernike_sum_der_xy,
    nm_to_fringe, nm_to_ansi_j, ansi_j_to_nm, noll_to_nm, fringe_to_nm,
    nm_to_name, top_n, zernikes_to_magnitude_angle,
    zernikes_to_magnitude_angle_nmkey, zero_separation, barplot, barplot_magnitudes,
)
from .zernike import (  # NOQA
    barplot as zernike_barplot,
    barplot_magnitudes as zernike_barplot_magnitudes,
)
from .zernike import zero_separation as zernike_zero_separation  # NOQA
from .fitting import (  # NOQA
    sum_of_2d_modes, sum_of_2d_modes_adjoint, hopkins, lstsq,
    normalize_modes, orthogonalize_modes,
)
from .cheby import (  # NOQA
    cheby1, cheby1_seq, cheby1_der, cheby1_der_seq,
    cheby2, cheby2_seq, cheby2_der, cheby2_der_seq,
    cheby3, cheby3_seq, cheby3_der, cheby3_der_seq,
    cheby4, cheby4_seq, cheby4_der, cheby4_der_seq,
    cheby1_2d_sum, cheby1_2d_sum_der_xy,
)
from .legendre import (  # NOQA
    legendre, legendre_seq, legendre_der, legendre_der_seq,
)
from .hermite import (  # NOQA
    hermite_He, hermite_He_seq, hermite_He_der, hermite_He_der_seq,
    hermite_H, hermite_H_seq, hermite_H_der, hermite_H_der_seq,
)
from .dickson import (  # NOQA
    dickson1, dickson1_seq, dickson1_der, dickson1_der_seq,
    dickson2, dickson2_seq, dickson2_der, dickson2_der_seq,
)
from .laguerre import (  # NOQA
    laguerre, laguerre_seq, laguerre_der, laguerre_der_seq,
)
from .xy import (  # NOQA
    xy, xy_seq, xy_der_x, xy_der_y, xy_der_xy,
    xy_der_x_seq, xy_der_y_seq, xy_der_xy_seq,
    xy_sum, xy_sum_der_xy, xy_j_to_mn,
)
from .qpoly import (  # NOQA
    Qbfs, Qbfs_seq, Qbfs_der, Qbfs_der_seq,
    Qcon, Qcon_seq, Qcon_der, Qcon_der_seq,
    Q2d, Q2d_seq, Q2d_der, Q2d_der_xy, Q2d_der_seq, Q2d_der_xy_seq,
    compute_z_zprime_Qbfs, compute_z_Qbfs,
    compute_z_zprime_Qcon,
    compute_z_zprime_Q2d, compute_z_Q2d, Q2d_nm_c_to_a_b,
    clenshaw_qbfs, clenshaw_qbfs_der, clenshaw_q2d, clenshaw_q2d_der,
    change_basis_Qbfs_to_Pn, change_of_basis_Q2d_to_Pnm,
)
