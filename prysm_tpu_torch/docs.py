"""The port's executed documentation: the python blocks of ``docs/torch/``.

Each doc under ``docs/torch/`` answers to the JAX package's doc at the same
relative path under ``docs/``.  ``EXECUTED`` names the docs whose python
blocks run as one program, with the number of leading blocks that run
(None: all), as ``tests/test_docs_snippets.py`` names their JAX twins; the
rest are fragments that only compile.  ``run`` executes a doc block by block
in one namespace, on ``config.device`` in ``config.precision``, in the
current directory.  ``RESULTS`` names, for each executed doc, the values
that are compared across packages, devices and precisions, each with the
float32 tier of its kind (``tests/test_f32_tier.py``).

Random draws: ``Draws`` records the draws of ``torch.rand`` / ``torch.randn``
made during one run and replays them into another, so that runs on devices
or in dtypes whose generators differ see the same numbers.
"""
import contextlib
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import torch

__all__ = ['DOCS', 'EXECUTED', 'DRAWING', 'REPLAYED', 'RESULTS', 'Draws', 'doc_paths', 'blocks',
           'run', 'value', 'host', 'relative_error', 'frame_moments', 'in_directory']

DOCS = Path(__file__).resolve().parent.parent / 'docs' / 'torch'

# doc -> number of leading blocks to execute (None = all); the same table as the JAX
# package's docs test
EXECUTED = {
    'tutorials/01-first-psf.md': None,
    'tutorials/02-phase-retrieval.md': 3,
    'tutorials/03-raytracing.md': None,
    'tutorials/05-image-simulation.md': None,
    'tutorials/06-interferometry.md': None,
    'tutorials/07-jones-calculus.md': None,
    'tutorials/08-fibers.md': None,
    'tutorials/09-double-slit.md': None,
    'tutorials/10-lens-mtf.md': None,
    'how-tos/telescope-apertures.md': None,
    'how-tos/radiometry.md': None,
    'how-tos/optimization.md': None,
    'how-tos/polychromatic.md': 2,
    'how-tos/polarized-propagation.md': None,
    'how-tos/advanced-interferogram-processing.md': None,
    'explanation/deformable-mirrors.md': None,
    'explanation/segmented-systems.md': None,
    'explanation/ins-and-outs-of-polynomials.md': None,
    'college/101-how-prysm-tpu-works.md': None,
    'college/102-precision-and-dispatch.md': None,
    'college/103-coordinates-grids-and-units.md': None,
    'college/104-richdata-and-io.md': None,
    'college/201-zernikes-on-a-circle.md': None,
    'college/202-other-bases-and-derivatives.md': None,
    'college/203-orthogonalizing-arbitrary-apertures.md': None,
    'college/204-forbes-q-and-clenshaw.md': None,
    'college/205-analytic-derivatives-payoff.md': None,
    'college/301-a-first-diffraction-model.md': None,
    'college/302-fixed-sampling-dft.md': None,
    'college/303-pupils-apertures-and-the-psf.md': None,
    'college/304-coronagraphs-and-dark-holes.md': None,
}

# blocks that only draw with matplotlib (doc -> block indices); ``run`` skips them where
# matplotlib is not installed and says so
DRAWING = {
    'tutorials/06-interferometry.md': (4,),
    'tutorials/09-double-slit.md': (3,),
    'tutorials/10-lens-mtf.md': (4,),
}

# docs whose random draws (torch.rand / randn) are replayed from a reference run into the
# runs compared with it; the other docs' draws are their own (05's frames are compared by
# their statistics)
REPLAYED = ('tutorials/06-interferometry.md', 'how-tos/telescope-apertures.md',
            'how-tos/advanced-interferogram-processing.md')

# doc -> {result: float32 tier}: the values compared across packages, devices and
# precisions.  A name is a variable of the doc's namespace or its attribute ('psf.data').  The tiers are tests/test_f32_tier.py's kinds.
RESULTS = {
    'tutorials/01-first-psf.md': {
        'amp': 'psf', 'opd': 'zernike', 'psf.data': 'psf', 'mtf.data': 'mtf', 'ee': 'psf',
        'w': 'psf'},
    'tutorials/02-phase-retrieval.md': {
        'I_meas': 'psf', 'value': 'grad', 'grad': 'grad', 'recovered': 'design'},
    'tutorials/03-raytracing.md': {
        'result.P': 'ray', 'opd': 'ray', 'spots': 'ray', 'seidel.sums': 'ray', 'res.x': 'design',
        'sens.jacobian': 'design', 'tol': 'design'},
    'tutorials/05-image-simulation.md': {
        'star': 'psf', 'psf.data': 'psf', 'kernel': 'psf', 'blurred': 'psf', 'aerial': 'psf',
        'sampled': 'psf', 'frame': 'noise', 'frame_fused': 'noise'},
    'tutorials/06-interferometry.md': {
        'itf.data': 'stats', 'pv': 'stats', 'rms': 'stats', 'sa': 'stats',
        'strehl_est': 'stats'},
    'tutorials/07-jones-calculus.md': {
        'out': 'zernike', 'I_t': 'zernike', 'vvr': 'zernike', 'M': 'zernike', 'c': 'zernike'},
    'tutorials/08-fibers.md': {
        'v': 'zernike', 'modes': 'fiber', 'lp01': 'fiber', 'w_marcuse': 'fiber', 'eta': 'fiber'},
    'tutorials/09-double-slit.md': {
        'aperture': 'psf', 'farfield.data': 'psf', 'first_max': 'psf', 'finite.data': 'psf',
        'measured': 'psf'},
    'tutorials/10-lens-mtf.md': {
        'aperture': 'psf', 'psf.data': 'psf', 'mtf.data': 'mtf', 'difflim': 'mtf',
        'mtf2.data': 'mtf'},
    'how-tos/telescope-apertures.md': {
        'hst': 'psf', 'jwst': 'psf', 'opd': 'zernike', 'luvoir': 'psf'},
    'how-tos/radiometry.md': {
        'psf.data': 'psf', 'e_pupil': 'psf', 'e_focal': 'psf', 'aerial': 'psf'},
    'how-tos/optimization.md': {
        'f0': 'grad', 'g0': 'grad', 'fk': 'design', 'result.x': 'design'},
    'how-tos/polychromatic.md': {
        'amp': 'psf', 'psf': 'psf'},
    'how-tos/polarized-propagation.md': {
        'vvr': 'zernike', 'j_out': 'psf', 'a_out': 'psf', 'unpol': 'psf'},
    'how-tos/advanced-interferogram-processing.md': {
        'pv': 'stats', 'pvr': 'stats', 'psd.data': 'stats', 'coefs': 'fit', 'mid': 'stats',
        'v_low': 'stats', 'v_hi': 'stats', 'tis': 'stats'},
    'explanation/deformable-mirrors.md': {
        'sfe': 'zernike', 'g': 'grad', 'a': 'grad'},
    'explanation/segmented-systems.md': {
        'cha.amp': 'psf', 'opd': 'zernike', 'I': 'psf', 'g': 'grad', 'c': 'grad'},
    'explanation/ins-and-outs-of-polynomials.md': {
        'T': 'zernike', 'G': 'zernike', 'Z4': 'zernike', 'g': 'zernike'},
    'college/101-how-prysm-tpu-works.md': {
        'amp': 'psf', 'psf_plane.data': 'psf', 'psf': 'psf', 'I_target': 'psf', 'g': 'grad'},
    'college/102-precision-and-dispatch.md': {
        'W': 'zernike', 'frame': 'noise'},
    'college/103-coordinates-grids-and-units.md': {
        'x': 'zernike', 'r': 'zernike', 'psf_dx': 'zernike', 'R': 'zernike'},
    'college/104-richdata-and-io.md': {
        'v': 'zernike', 'azavg': 'zernike', 'ig.pv': 'stats', 'ig.rms': 'stats'},
    'college/201-zernikes-on-a-circle.md': {
        'z22': 'zernike', 'modes': 'zernike', 'W': 'zernike', 'coefs_fit': 'fit'},
    'college/202-other-bases-and-derivatives.md': {
        'T': 'zernike', 'P': 'zernike', 'q3': 'zernike', 'qc': 'zernike', 'q2d': 'zernike',
        'ders': 'zernike', 'W': 'zernike', 'dWdx': 'zernike', 'dWdy': 'zernike'},
    'college/203-orthogonalizing-arbitrary-apertures.md': {
        'G_disk': 'zernike', 'G_ann': 'zernike', 'Q': 'fit', 'c_full': 'fit', 'c_trunc': 'fit'},
    'college/204-forbes-q-and-clenshaw.md': {
        'Q2': 'zernike', 'z': 'zernike', 'dzdr': 'zernike', 'dzdt': 'zernike'},
    'college/205-analytic-derivatives-payoff.md': {
        'dzdx': 'zernike', 'dzdy': 'zernike', 'W': 'zernike', 'Wx': 'zernike',
        'Wy': 'zernike', 'z': 'ray', 'n': 'ray'},
    'college/301-a-first-diffraction-model.md': {
        'psf.data': 'psf', 'analytic': 'psf', 'mtf.data': 'mtf', 'limit': 'mtf'},
    'college/302-fixed-sampling-dft.md': {
        'E.data': 'psf', 'I': 'psf', 'E2.data': 'psf'},
    'college/303-pupils-apertures-and-the-psf.md': {
        'psf_circ.data': 'psf', 'psf_ann.data': 'psf', 'psf_tel.data': 'psf',
        'psf_ab.data': 'psf', 'strehl': 'psf'},
    'college/304-coronagraphs-and-dark-holes.md': {
        'after.data': 'babinet', 'I_corona': 'babinet', 'l1': 'babinet', 'l2': 'babinet',
        'e0': 'babinet', 'c': 'design', 'e1': 'babinet'},
}

_BLOCK = re.compile(r'```python\n(.*?)```', re.S)


def doc_paths():
    """Every doc of ``docs/torch/``, as paths relative to it."""
    return sorted(p.relative_to(DOCS).as_posix() for p in DOCS.rglob('*.md'))


def blocks(relpath):
    """The python blocks of ``docs/torch/<relpath>``, in order."""
    return _BLOCK.findall((DOCS / relpath).read_text())


def _can_draw():
    return importlib.util.find_spec('matplotlib') is not None


class Draws:
    """The draws of ``torch.rand`` and ``torch.randn`` of one run, replayed into another.

    ``Draws()`` records (host float64 copies, in call order); ``Draws(recorded)`` with
    another's ``recorded`` replays them: each call returns the next recorded array of its
    kind, in the dtype and on the device the call asks for, and must ask for its shape.
    """

    def __init__(self, recorded=None):
        self.replaying = recorded is not None
        self.recorded = {'rand': [], 'randn': []} if recorded is None else {
            k: list(v) for k, v in recorded.items()}

    @contextlib.contextmanager
    def active(self):
        originals = {k: getattr(torch, k) for k in self.recorded}
        for kind, fn in originals.items():
            setattr(torch, kind, self._wrap(kind, fn))
        try:
            yield self
        finally:
            for kind, fn in originals.items():
                setattr(torch, kind, fn)

    def _wrap(self, kind, fn):
        def drawn(*size, generator=None, dtype=None, device=None, **kwargs):
            shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
            if not self.replaying:
                out = fn(*size, generator=generator, dtype=dtype, device=device, **kwargs)
                self.recorded[kind].append(out.detach().cpu().double().numpy())
                return out
            if not self.recorded[kind]:
                raise RuntimeError(f'no recorded torch.{kind} draw is left to replay')
            a = np.array(self.recorded[kind].pop(0))
            if a.shape != shape:
                raise RuntimeError(f'torch.{kind} asked for {shape}; the recorded draw is '
                                   f'{a.shape}')
            return torch.as_tensor(a, dtype=dtype or torch.get_default_dtype(),
                                   device=device or 'cpu')
        return drawn


@contextlib.contextmanager
def in_directory(path):
    """Run a block with ``path`` as the current directory, restored after."""
    saved = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(saved)


@contextlib.contextmanager
def _restored():
    """Leave the configuration, torch's TF32 switch and the propagation package's
    functions (which ``x.polarization.add_jones_propagation`` patches) as they were."""
    from . import propagation
    from .conf import config
    saved = (config._precision, config._device, torch.backends.cuda.matmul.allow_tf32,
             dict(vars(propagation)))
    try:
        yield
    finally:
        config._precision, config._device, torch.backends.cuda.matmul.allow_tf32 = saved[:3]
        for name, fn in saved[3].items():
            setattr(propagation, name, fn)


def run(relpath, draws=None):
    """Execute the doc's python blocks (its ``EXECUTED`` leading ones, or all) in one
    namespace, on ``config.device`` in ``config.precision``, in the current directory.

    The configuration, the TF32 switch and the propagation package are restored after.
    ``draws``: a ``Draws`` the blocks' random draws are recorded into or replayed from.
    Blocks of ``DRAWING`` are skipped where matplotlib is not installed.  Returns the namespace, with
    the list of skipped block indices under ``'__skipped__'``.
    """
    code = blocks(relpath)
    if not code:
        raise AssertionError(f'{relpath} has no python blocks')
    limit = EXECUTED.get(relpath)
    code = code[:limit] if limit is not None else code
    skip = () if _can_draw() else DRAWING.get(relpath, ())
    ns = {'__name__': '__doc__'}
    with _restored(), draws.active() if draws is not None else contextlib.nullcontext():
        for k, block in enumerate(code):
            if k in skip:
                continue
            try:
                exec(compile(block, f'{relpath}[block {k}]', 'exec'), ns)
            except Exception as e:
                raise AssertionError(f'{relpath} block {k} failed: {type(e).__name__}: {e}\n'
                                     f'--- block ---\n{block}') from e
    ns['__skipped__'] = list(skip)
    return ns


def host(v):
    """A result as a host numpy array (float64 or complex128)."""
    if isinstance(v, dict):
        return np.concatenate([np.ravel(host(v[k])) for k in sorted(v)])
    if isinstance(v, (list, tuple)):
        return np.concatenate([np.ravel(host(e)) for e in v]) if v else np.zeros(0)
    if torch.is_tensor(v):
        v = v.detach().cpu()
        v = v.resolve_conj().numpy() if v.is_complex() else v.double().numpy()
    a = np.asarray(v)
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def value(ns, name):
    """The result ``name`` of a doc's namespace (a variable, or its attribute: 'psf.data')
    on the host."""
    variable, *attrs = name.split('.')
    v = ns[variable]
    for attr in attrs:
        v = getattr(v, attr)
    return host(v)


def relative_error(a, b):
    """max |a - b| over max |b| (max |a - b| where b is all zero) of two results of one
    shape, over the samples where both are finite; raises where they are non-finite at
    different samples."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f'shapes differ: {a.shape} against {b.shape}')
    finite = np.isfinite(b)
    if not np.array_equal(np.isfinite(a), finite):
        raise ValueError(f'non-finite at other samples ({int((~np.isfinite(a)).sum())} '
                         f'against {int((~finite).sum())})')
    if not finite.any():
        return 0.0
    a, b = a[finite], b[finite]
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / (scale if scale > 0 else 1.0))


def frame_moments(a, b):
    """(relative difference of the means, of the spreads) of two noisy frames of one
    scene; a frame the ADC clips flat has a spread of 0, and two such frames differ by 0."""
    ma, mb, sa, sb = np.mean(a), np.mean(b), np.std(a), np.std(b)
    return float(abs(ma - mb) / abs(mb)), float(abs(sa - sb) / sb if sb > 0 else sa)
