"""Design a V-coat antireflection coating with analytic gradients.

Refines layer thicknesses of an H/L pair on BK7 against a visible-band
reflectance merit using the coatings gradient engine, then reports the
spectrum and a deposition monitoring curve.  The coatings evaluate on
``device`` (``config.device``) in ``config.precision``.
"""
import numpy as np

from ..conf import device_as, resolve_device
from ..mathops import array_to_true_numpy
from ..x import coatings as coat

W0 = 0.55
WVLS = np.linspace(0.45, 0.65, 41)


def v_coat():
    """The deliberately mis-thicknessed start (indices ambient side first)."""
    nL, nM, nsub = 1.38, 1.70, 1.52   # MgF2 over a medium-index layer
    return coat.Stack([nL, nM], [W0 / (4 * nL) * 1.2, W0 / (4 * nM) * 0.85], nsub)


def band_reflectance(stack):
    """The s-polarized reflectance averaged over 0.45-0.65 um at normal incidence."""
    return array_to_true_numpy(coat.RTA(stack, WVLS, 0.0, 's')[0]).mean()


def refine(stack):
    """L-BFGS-B over the thicknesses against R = 0 across the band (a CoatingResult)."""
    return coat.refine(stack, coat.Reflectance(WVLS, target=0.0), method='lbfgsb',
                       maxiter=200)


def main(plot=False, device=None):
    with device_as(resolve_device(device)):
        stack = v_coat()
        R0 = band_reflectance(stack)
        stack = refine(stack).stack
        R1 = band_reflectance(stack)
        print(f'band-average R: {R0:.4%} -> {R1:.4%}')
        print('thicknesses (um):', np.round(array_to_true_numpy(stack.thicknesses), 5))

        d, sig = coat.monitoring_trace(stack, 0, W0)
        print(f'monitor swing while depositing layer 0: '
              f'{float(np.ptp(array_to_true_numpy(sig))):.4f}')

        if plot:
            import matplotlib.pyplot as plt
            fig, axs = plt.subplots(1, 2, figsize=(9, 3.5))
            coat.plot_spectrum(stack, WVLS, fig=fig, ax=axs[0])
            coat.plot_monitoring_trace(stack, 0, W0, fig=fig, ax=axs[1])
            plt.show()
    return R1


if __name__ == '__main__':
    main(plot=False)
