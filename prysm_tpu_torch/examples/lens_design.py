"""Design, optimize, tolerance, and draw a cemented doublet.

End-to-end sequential-raytracing workflow: build the prescription with
the LensData editor, hold EFL with a constraint while minimizing RMS
spot via exact adjoint gradients, then budget manufacturing tolerances
from the adjoint Jacobian and render the layout.  The traces run on
``device`` (``config.device``) in ``config.precision``; the host planners
read back from it.
"""
import warnings

from ..conf import device_as, resolve_device
from ..mathops import array_to_true_numpy
from ..x import raytracing as rt
from ..x import materials as mat
from ..x.raytracing.design import _TraceCache

WVL = 0.5876


def doublet():
    """The BK7/SF5 doublet at f/5, its image distance solved (on ``config.device``)."""
    bk7 = mat.model_glass(1.5168, 64.17, name='BK7')
    sf5 = mat.model_glass(1.6727, 32.2, name='SF5')
    lens = rt.LensData()
    lens.add(rt.Sphere(1 / 62.0), thickness=6.0, material=bk7)
    lens.add(rt.Sphere(-1 / 45.0), thickness=3.0, material=sf5)
    lens.add(rt.Sphere(-1 / 128.0), thickness=95.6, material=mat.air)
    sys_ = rt.OpticalSystem(lens, aperture=20.0,
                            fields=[rt.Field(0, 0), rt.Field(0, 2.0)],
                            wavelengths=[WVL], stop_index=1)
    sys_.solve.image_distance()
    return sys_


def optimize(sys_):
    """(problem, start merit, DLS result): spots at two fields, EFL held exactly,
    over the first and last curvatures; the lens is left at the result."""
    sys_.opt.vary('curvature', [1, 3])
    prob = rt.Problem(
        sys_,
        [rt.RmsSpotRadius(field=sys_.field(i), sampling=rt.Sampling.hex(4))
         for i in (0, 1)],
        constraints=[rt.EFL(target=100.0)], gradient='auto')
    m0 = prob.merit(prob.x0())
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        res = prob.solve(maxiter=30)
    return prob, m0, res


def tolerances(sys_):
    """(adjoint sensitivities, per-parameter tolerances for a 5 um spot-growth budget)."""
    adj = rt.adjoint
    P, S = rt.launch(sys_, sys_.field(), WVL, rt.Sampling.hex(5))
    seeds = [adj.seed_curvature(1, name='c1'),
             adj.seed_curvature(2, name='c2'),
             adj.seed_curvature(3, name='c3'),
             adj.seed_decenter(2, 'y', name='dy2'),
             adj.seed_tilt(2, 'x', name='tx2')]
    sens = adj.multi_objective_sensitivity(
        sys_, *array_to_true_numpy(P, S), WVL, seeds,
        [adj.RmsSpotHead(), adj.BoresightHead()])
    return sens, adj.inverse_sensitivity(sens.jacobian, budget=5e-3)


def main(plot=False, device=None):
    with device_as(resolve_device(device)):
        sys_ = doublet()

        # --- optimize: spots at two fields, EFL held exactly -------------
        prob, m0, res = optimize(sys_)
        efl = rt.EFL()(sys_, _TraceCache(sys_))
        print(f'merit {m0:.3e} -> {prob.merit(res.x):.3e} in {res.nit} it; '
              f'EFL = {efl:.6f} (target 100)')

        # --- tolerance: adjoint Jacobian -> per-parameter budget ---------
        sens, tol = tolerances(sys_)
        print('tolerances for a 5 um spot-growth budget:')
        for name, t in zip(sens.param_names, tol):
            print(f'  {name:5s} {t:.3e}')

        if plot:
            sys_.plot.layout_2d()
            import matplotlib.pyplot as plt
            plt.show()
    return sys_


if __name__ == '__main__':
    main(plot=False)
