"""Optical fiber routines: V-number, LP mode solving, overlap integrals.

Counterpart of ``prysm_tpu/x/fibers.py``.  Mode solving and the mode fields
are host-side SciPy (``jv``, ``kv``, ``kve``, ``jn_zeros``: torch has no
Bessel functions of general order), a setup step; the fields come back as
tensors on the caller's device (the grid's, when it is a tensor, else
``config.device``) so overlap integrals and propagation run there.
"""
import numpy as onp
import torch
from scipy import special as _sp

from ..conf import config, resolve_device


def _host_grid(r):
    """(r as a host numpy array in its own dtype, the dtype and device of the fields out)."""
    if torch.is_tensor(r):
        return r.detach().cpu().numpy(), r.dtype, r.device
    return onp.asarray(r), config.precision, resolve_device()

_JZERO_MEMO = {}


def critical_angle(n_core, n_clad,
                   deg=True):
    """TIR angle of a step index fiber."""
    ang = onp.arcsin(n_clad / n_core)
    return onp.degrees(ang) if deg else ang


def numerical_aperture(n_core, n_clad):  # sqrt(n1^2 - n2^2)
    """NA of a step-index fiber."""
    return onp.sqrt(n_core * n_core - n_clad * n_clad)


def V(radius, NA, wavelength):  # NOQA: N802 - domain name
    """V-number (normalized frequency): k * r * NA."""
    return 2 * onp.pi / wavelength * radius * NA


def _ghatak_eq_8_40(b, V, l):  # NOQA - single-letter physics symbols
    """Ghatak Eq. 8.40/8.41 LHS - RHS; roots are propagating modes."""
    U = V * onp.sqrt(1 - b)
    W = V * onp.sqrt(b)
    with onp.errstate(divide='ignore', invalid='ignore'):
        if l >= 1:
            left = U * _sp.jv(l - 1, U) / _sp.jv(l, U)
            right = -(W * _sp.kve(l - 1, W) / _sp.kve(l, W))
        else:
            left = (U * _sp.j1(U)) / _sp.j0(U)
            right = (W * _sp.k1(W)) / _sp.k0(W)
    return left - right


def _besselj_positive_zeros(l, x_max):  # NOQA
    """All positive zeros of J_l strictly below x_max, ascending (cached)."""
    x_max = float(x_max)  # zeros strictly below this bound
    cache_key = int(l)
    hit = _JZERO_MEMO.get(cache_key)
    if hit is not None:
        seen_to, zeros_known = hit
        if seen_to >= x_max:
            return zeros_known[zeros_known < x_max].copy()
    nt = max(8, int(x_max / onp.pi) + 8)
    while True:
        zeros = onp.asarray(_sp.jn_zeros(l, nt))
        if zeros[-1] >= x_max:
            zeros = zeros[zeros < x_max]  # trim the overshoot batch
            _JZERO_MEMO[cache_key] = (x_max, zeros)
            return zeros.copy()  # never hand out the cached buffer
        nt *= 2


def _ghatak_u_with_derivative(U, V, ell):  # noqa: N803
    """Dispersion equation f(U) and df/dU, U-parameterized (W^2 = V^2 - U^2)."""
    W = onp.sqrt(V * V - U * U)
    with onp.errstate(divide='ignore', invalid='ignore'):
        if ell == 0:
            rj = _sp.j1(U) / _sp.j0(U)
            rk = _sp.k1(W) / _sp.k0(W)
            f = U * rj - W * rk
            df = U * (rj * rj + rk * rk)
        else:
            rj = _sp.jv(ell - 1, U) / _sp.jv(ell, U)
            rk = _sp.kve(ell - 1, W) / _sp.kve(ell, W)
            f = U * rj + W * rk
            df = 2 * ell * (rj - U * rk / W) - U * (rj * rj + rk * rk)
    return f, df


def _vectorized_safeguarded_newton_u(V, ell, lower, upper,
                                     max_iter=28, atol=1e-12):
    """Batched safeguarded Newton on f(U)=0, bisection fallback per root."""
    a = onp.asarray(lower).copy()
    b = onp.asarray(upper).copy()
    fa = _ghatak_u_with_derivative(a, V, ell)[0]
    x = (a + b) * 0.5
    fx, dfx = _ghatak_u_with_derivative(x, V, ell)
    for _iteration in range(max_iter):
        converged = onp.abs(fx) < atol
        step = onp.where(dfx != 0, -fx / dfx, 0.0)
        x_newton = step + x
        in_bracket = (x_newton < b) & (x_newton > a)
        x_new = onp.where(in_bracket, x_newton, 0.5 * (a + b))
        x_new = onp.where(converged, x, x_new)
        f_new, df_new = _ghatak_u_with_derivative(
            x_new, V, ell)
        update = ~converged  # frozen lanes keep their root
        same_sign_as_a = onp.sign(f_new) == onp.sign(fa)
        a = onp.where(update & same_sign_as_a, x_new, a)
        fa = onp.where(update & same_sign_as_a, f_new, fa)
        b = onp.where(update & ~same_sign_as_a, x_new, b)
        x = x_new
        fx = f_new
        dfx = df_new
        if bool(onp.all(onp.abs(fx) < atol)):
            break
    return x


def _mode_u_brackets(V, cutoffs, poles):  # noqa: N803
    """(lower, upper) U brackets implied by LP cutoff/pole theory."""
    if not len(cutoffs):
        return onp.empty(0), onp.empty(0)
    V = float(V)
    tiny_u = onp.sqrt(onp.finfo(onp.float64).eps) * max(V, 1.0)
    lower = []
    upper = []
    for idx, cutoff_u in enumerate(cutoffs):
        cutoff_u = float(cutoff_u)
        pole_u = V if idx >= len(poles) else float(poles[idx])
        upper_u = min(pole_u, V)
        span = upper_u - cutoff_u
        if not span > 0:
            continue
        du = min(tiny_u, span * 1e-3)
        left_u = du if cutoff_u <= 0 else cutoff_u + du
        right_u = -du + upper_u
        if not right_u > left_u:
            continue
        lower += [left_u]
        upper += [right_u]
    return onp.asarray(lower), onp.asarray(upper)


def _families(V):  # noqa: N803
    """Yield (ell, cutoffs, poles) per LP family present at this V."""
    zero_cache = {}  # order -> positive j_l zeros below V

    def zeros(order):
        try:
            return zero_cache[order]
        except KeyError:
            zero_cache[order] = _besselj_positive_zeros(order, V)
            return zero_cache[order]

    yield 0, onp.concatenate((onp.asarray([0.0]), zeros(1))), zeros(0)
    ell = 1
    while True:
        cutoffs = zeros(ell - 1)  # LP_l cutoffs are j_{l-1} zeros
        if not len(cutoffs):
            return
        yield (ell, cutoffs, zeros(ell))
        ell += 1


def find_all_modes(V, count_only=False):  # noqa: N803
    """Identify the LP modes of a step-index fiber: {l: b values} descending."""
    out = {}
    for ell, cutoffs, poles in _families(V):
        if count_only:
            n = int(len(cutoffs))
            out[ell] = n
            if ell > 0:
                out[-ell] = n  # sine family twin
            continue
        lower, upper = _mode_u_brackets(V, cutoffs, poles)
        if not len(lower):
            continue
        roots_u = _vectorized_safeguarded_newton_u(V, ell, lower,
                                                   upper)
        roots_b = (1.0 - (roots_u / V) ** 2)[::-1]
        out[+ell] = roots_b
        if ell > 0:
            out[-ell] = roots_b  # degenerate sine family
    return out


def compute_LP_modes(V, mode_dict, a, r, t):  # noqa: N802,N803
    """Spatial LP mode fields; same structure as find_all_modes, tensor values."""
    r, dtype, device = _host_grid(r)
    t = _host_grid(t)[0]
    rnorm = r / a
    within_core = r <= a
    within_clad = onp.logical_not(within_core)
    max_l = max(mode_dict)
    sines = {}
    cosines = {}
    for l in range(1, max_l + 1):  # NOQA
        sines[l] = onp.sin(l * t)
        cosines[l] = onp.cos(l * t)
    out = {}
    for l, blist in mode_dict.items():  # NOQA - l is the azimuthal order
        bs = blist[::-1]
        modes_l = []
        for b in bs:
            U = V * onp.sqrt(1 - b)
            W = V * onp.sqrt(b)
            tmp = onp.zeros_like(r)
            al = abs(l)
            if al == 0:
                num_core = _sp.j0(U * rnorm[within_core])
                den_core = _sp.j0(U)  # l=0 fast path
                num_clad = _sp.k0(W * rnorm[within_clad])
                den_clad = _sp.k0(W)
            elif al == 1:
                num_core = _sp.j1(U * rnorm[within_core])
                den_core = _sp.j1(U)
                num_clad = _sp.k1(W * rnorm[within_clad])
                den_clad = _sp.k1(W)
            else:
                num_core = _sp.jv(al, U * rnorm[within_core])
                den_core = _sp.jv(al, U)
                num_clad = _sp.kv(al, W * rnorm[within_clad])
                den_clad = _sp.kv(al, W)
            with onp.errstate(divide='ignore', invalid='ignore'):
                tmp[within_core] = num_core / den_core
                tmp[within_clad] = num_clad / den_clad
            if l != 0:
                tmp = tmp * (sines[-l] if l < 0 else cosines[l])
            modes_l.append(torch.as_tensor(tmp, dtype=dtype, device=device))
        out[l] = modes_l  # stacked radial orders for this l
    return out


def smf_mode_field(V, a, b, r):  # noqa: N803
    """Mode field of a single mode fiber (host-solved, tensor output)."""
    r, dtype, device = _host_grid(r)
    U = V * onp.sqrt(1 - b)
    W = V * onp.sqrt(b)
    rnorm = r * (1 / a)
    rinterior = rnorm < 1.0
    out = onp.empty_like(r)
    with onp.errstate(divide='ignore', invalid='ignore'):
        out[rinterior] = _sp.j0(U * rnorm[rinterior]) * (1 / _sp.j1(U))
        rexterior = onp.logical_not(rinterior)
        out[rexterior] = _sp.k0(W * rnorm[rexterior]) * (1 / _sp.k1(W))
    return torch.as_tensor(out, dtype=dtype, device=device)


def marcuse_mfr_from_V(V):  # noqa: N802,N803
    """Marcuse estimate of mode field radius over core radius (w/a)."""
    return 0.65 + (1.619 * V ** -1.5) + (2.879 * V ** -6)


def petermann_mfr_from_V(V):  # noqa: N802,N803
    """Petermann estimate of w/a; more accurate than Marcuse."""
    return (marcuse_mfr_from_V(V) - 0.016) - 1.567 * V ** -7


def mode_overlap_integral(E1, E2, E2conj=None, I1sum=None,
                          I2sum=None):
    """Coupling efficiency eta = |int E1* E2|^2 / (int I1 int I2)."""
    if I1sum is None:  # allow precomputed power for repeated overlaps
        I1 = torch.abs(E1) ** 2
        I1sum = torch.sum(I1)
    if I2sum is None:
        I2 = torch.abs(E2) ** 2
        I2sum = torch.sum(I2)
    if E2conj is None:  # conjugation is the caller-amortizable half
        E2conj = torch.conj(E2)
    num = torch.abs(torch.sum(E1 * E2conj)) ** 2
    return num / (I1sum * I2sum)


def multimode_coupling(E_in, mode_fields):  # LP-basis power budget
    """Per-LP-mode coupling efficiencies of an incident field."""
    I_in = torch.abs(E_in) ** 2
    I_in_sum = torch.sum(I_in)
    E_in_conj = torch.conj(E_in)
    out = {}
    for l, modes in mode_fields.items():  # NOQA - azimuthal order key
        out[l] = [
            mode_overlap_integral(mode, E_in, E2conj=E_in_conj,
                                  I2sum=I_in_sum)
            for mode in modes
        ]
    return out
