"""The yardstick of a kernel: the work an operation needs, and the least time the card
could take for it.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at the
full 700 W; a card set below it runs slower, so every result carries the
card's name and power limit beside it).  Work is counted from what the
operation needs, whatever implements it: each input byte read once and each
output byte written once, and the fewest operations the algorithm takes.
A faster implementation therefore cannot lower its own yardstick.
"""
from collections import defaultdict

H100_SXM = {
    'hbm_bytes_per_s': 3.35e12,
    'fp32_flops_per_s': 67e12,
}


def least_seconds(flops, nbytes, peaks=H100_SXM):
    """(seconds, 'bytes' or 'flops'): the larger of the two bounds and which one."""
    t_bytes = nbytes / peaks['hbm_bytes_per_s']
    t_flops = flops / peaks['fp32_flops_per_s']
    return (t_bytes, 'bytes') if t_bytes >= t_flops else (t_flops, 'flops')


def roofline_percent(flops, nbytes, seconds, peaks=H100_SXM):
    """The least time over the measured time, in percent (never clipped)."""
    return 100.0 * least_seconds(flops, nbytes, peaks)[0] / seconds


def zernike_flops_per_pixel(nms):
    """Floating-point operations per pixel of sum_k c_k Z_{n_k m_k}(r, t) by the three-term
    Jacobi recurrence, counting an add, a multiply or a compare as one and a fused
    multiply-add as two, and a sine or a cosine as one (the least; the hardware takes
    more).  With the coefficients times their norms folded on the host:

    * x = 2 r^2 - 1: 3;
    * cos t and sin t: 2;
    * for |m| = 1 .. max |m|: the next cos(|m| t), sin(|m| t) by the angle sum (4
      multiplies, 2 adds) and r^|m| (1): 7 each;
    * for each |m| present, its Jacobi polynomials P_j^(0,|m|)(x) up to the largest
      order j = (n - |m|) / 2 any of its modes needs: 5 a step (A x + B: 2; times
      P_j: 1; C P_{j-1}: 1; the difference: 1);
    * for each (|m| > 0, cos or sin) present, the angular factor r^|m| cos|sin: 1;
    * for each mode, its share of the sum: 2 for m = 0 (a fused multiply-add), 3
      otherwise (P times the angular factor, times the coefficient, plus the sum).

    The coefficient gradient needs the same count: each mode's product with the
    cotangent, accumulated into its coefficient, in place of its share of the sum.
    """
    nms = [(int(n), int(m)) for n, m in nms]
    orders = defaultdict(int)
    for n, m in nms:
        orders[abs(m)] = max(orders[abs(m)], (n - abs(m)) // 2)
    m_max = max(orders)
    angular = {(abs(m), m > 0) for n, m in nms if m != 0}
    per_mode = sum(2 if m == 0 else 3 for _, m in nms)
    return 3 + 2 + 7 * m_max + 5 * sum(orders.values()) + len(angular) + per_mode


def zernike_work(nms, pixels):
    """(flops, bytes) of the synthesis (r and t read, the sum written, the coefficients
    read) or of its coefficient gradient (r, t and the cotangent read, one value a
    coefficient written): the same, in float32."""
    return zernike_flops_per_pixel(nms) * pixels, 3 * 4 * pixels + 4 * len(nms)
