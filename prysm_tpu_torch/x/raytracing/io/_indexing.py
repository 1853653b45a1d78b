"""Polynomial index conversions re-exported for the IO parsers."""
from ....polynomials import fringe_to_nm, noll_to_nm, xy_j_to_mn  # NOQA: F401
