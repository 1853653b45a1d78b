"""Polynomial families: Jacobi and Zernike, plus mode summation."""
from .jacobi import jacobi, jacobi_seq, recurrence_abc  # NOQA
from .zernike import (  # NOQA
    zernike_norm, zernike_nm, zernike_nm_seq, zernike_sum,
    nm_to_fringe, nm_to_ansi_j, ansi_j_to_nm, noll_to_nm, fringe_to_nm,
)
from .fitting import sum_of_2d_modes, sum_of_2d_modes_adjoint  # NOQA
