"""Dispersion formulas (Sellmeier/Cauchy/Schott/AGF/refractiveindex.info).

Counterpart of ``prysm_tpu/x/materials/formulas.py``.  Plain numpy float
math: these evaluate at setup time on the host.
"""
import numpy as np


def _pairs(coefs):
    """Split an interleaved flat coefficient list into (even, odd) arrays."""
    c = np.asarray(coefs, dtype=float)
    return c[0::2], c[1::2]


def _power_series_nsq(wvl_um, coefs, powers):
    """n^2 as a power series sum_i c_i w^p_i, wavelength in microns."""
    w = np.asarray(wvl_um, dtype=float)
    nsq = 0.0
    for c, p in zip(coefs, powers):
        nsq = nsq + c * w ** p
    return nsq


def cauchy(wvl_um, A, *args):
    """Cauchy equation n = A + B/w^2 + C/w^4 + ..., wavelength in microns.

    Host-side numpy on purpose: materials evaluate at setup time.
    """
    powers = [-2 * k for k in range(1, len(args) + 1)]
    return A + 0 * np.asarray(wvl_um, dtype=float) + _power_series_nsq(
        wvl_um, args, powers)


def sellmeier(wvl_um, A, B):
    """Sellmeier equation n^2 = 1 + sum A_i w^2/(w^2 - B_i), microns.

    B carries the squared resonance wavelengths, matching the reference
    convention (prysm/refractive.py sellmeier).
    """
    w2 = np.asarray(wvl_um, dtype=float) ** 2
    nsq = 1.0 + 0 * w2
    A = np.atleast_1d(np.asarray(A, dtype=float))
    B = np.atleast_1d(np.asarray(B, dtype=float))
    for a, b in zip(A, B):
        nsq = nsq + a * w2 / (w2 - b)
    return np.sqrt(nsq)


_cauchy = cauchy
_sellmeier = sellmeier


def sellmeier_interleaved(wvl_um, *coefficients):
    """Sellmeier with interleaved A1, B1, A2, B2, ... coefficients."""
    return sellmeier(wvl_um, *_pairs(coefficients))


# n^2 power-series exponent tables for the AGF polynomial families
_SCHOTT_POW = (0, 2, -2, -4, -6, -8)
_EXT2_POW = _SCHOTT_POW + (4, 6)
_EXT3_POW = (0, 2, 4, -2, -4, -6, -8, -10, -12)


def schott(wvl_um, c0, c1, c2, c3, c4, c5):
    """Schott power-series equation (AGF formula 1)."""
    return np.sqrt(_power_series_nsq(
        wvl_um, (c0, c1, c2, c3, c4, c5), _SCHOTT_POW))


def extended2(wvl_um, c0, c1, c2, c3, c4, c5, c6, c7):
    """AGF Extended-2 equation (formula 12)."""
    return np.sqrt(_power_series_nsq(
        wvl_um, (c0, c1, c2, c3, c4, c5, c6, c7), _EXT2_POW))


def extended3(wvl_um, c0, c1, c2, c3, c4, c5, c6, c7, c8):
    """AGF Extended-3 equation (formula 13)."""
    return np.sqrt(_power_series_nsq(
        wvl_um, (c0, c1, c2, c3, c4, c5, c6, c7, c8), _EXT3_POW))


def _agf_sellmeier(coefficients, wvl_um, name, terms):
    needed = 2 * terms
    if len(coefficients) < needed:
        raise ValueError(
            f'AGF Sellmeier glass {name} requires {needed} coefficients')
    return sellmeier(wvl_um, *_pairs(coefficients[:needed]))


# formula id -> (evaluator, arity, spelled-out arity) for the polynomial ids
_AGF_POLY = {
    1: (schott, 6, 'six'),
    12: (extended2, 8, 'eight'),
    13: (extended3, 9, 'nine'),
}
_AGF_NAMES = {1: 'Schott formula', 12: 'Extended 2 formula',
              13: 'Extended 3 formula'}


def agf_formula(formula, wvl_um, *coefficients, name='material'):
    """Evaluate the supported Zemax AGF dispersion-formula ids.

    Coefficients trail the wavelength positionally so
    partial(agf_formula, fid) plugs straight into FormulaMaterial.
    """
    if formula in (2, 6):
        return _agf_sellmeier(coefficients, wvl_um, name,
                              terms=3 if formula == 2 else 4)
    try:
        fn, arity, word = _AGF_POLY[formula]
    except KeyError:
        raise NotImplementedError(
            f'AGF dispersion formula {formula} for {name} is not implemented')
    if len(coefficients) < arity:
        raise ValueError(f'AGF {_AGF_NAMES[formula]} glass {name} '
                         f'requires {word} coefficients')
    return fn(wvl_um, *coefficients[:arity])


def riinfo_formula(formula_id, wvl_um, *coefficients):
    """Evaluate refractiveindex.info dispersion formulas 1-9 (microns)."""
    wl = np.asarray(wvl_um, dtype=float)
    w2 = wl ** 2
    C = np.asarray(coefficients, dtype=float)
    Cp = np.concatenate([C, np.zeros(6)])
    c0 = Cp[0]
    tail_a, tail_b = _pairs(C[1:])

    if formula_id == 1:  # Sellmeier, resonances as sqrt
        nsq = 1 + c0
        for a, b in zip(tail_a, tail_b):
            nsq = nsq + a * w2 / (w2 - b ** 2)
        return np.sqrt(nsq)
    if formula_id == 2:  # Sellmeier-2, resonances squared already
        nsq = 1 + c0
        for a, b in zip(tail_a, tail_b):
            nsq = nsq + a * w2 / (w2 - b)
        return np.sqrt(nsq)
    if formula_id == 3:  # polynomial in powers of wl
        return np.sqrt(_power_series_nsq(wl, (c0, *tail_a),
                                         (0, *tail_b)))
    if formula_id == 4:  # RefractiveIndex.INFO mixed form
        nsq = c0
        for j in range(1, min(8, C.size), 4):
            nsq = nsq + Cp[j] * wl ** Cp[j + 1] / (w2 - Cp[j + 2] ** Cp[j + 3])
        resA, resB = _pairs(C[9:])
        for a, b in zip(resA, resB):
            nsq = nsq + a * wl ** b
        return np.sqrt(nsq)
    if formula_id == 5:  # Cauchy with arbitrary powers
        return c0 + _power_series_nsq(wl, tail_a, tail_b)
    if formula_id == 6:  # gases
        n = 1 + c0
        for a, b in zip(tail_a, tail_b):
            n = n + a / (b - wl ** (-2))
        return n
    if formula_id == 7:  # Herzberger
        L = 1 / (w2 - 0.028)
        n = c0 + Cp[1] * L + Cp[2] * L ** 2
        for k, c in enumerate(C[3:]):
            n = n + c * wl ** (2 * (k + 1))
        return n
    if formula_id == 8:  # retro
        tmp = c0 + Cp[1] * w2 / (w2 - Cp[2]) + Cp[3] * w2
        return np.sqrt((2 * tmp + 1) / (1 - tmp))
    if formula_id == 9:  # exotic
        shifted = wl - Cp[4]
        return np.sqrt(c0 + Cp[1] / (w2 - Cp[2])
                       + Cp[3] * shifted / (shifted ** 2 + Cp[5]))
    raise ValueError(
        f'unknown refractiveindex.info dispersion formula {formula_id}')
