"""The port stands alone: no JAX, no prysm_tpu, and no result without a card.

``prysm_tpu_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
the JAX package, not even its pure-Python modules.  ``chip_smoke.py``
must exit nonzero and print no result where no CUDA device is present.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
# the card tier runs where JAX is not installed: its files stand with the port's
TIER_FILES = sorted((ROOT / 'tests').glob('test_torch_chip_*.py'))
PORT_FILES = sorted((ROOT / 'prysm_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES + TIER_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_prysm_tpu_imports(path):
    for mod in _imported_modules(path):
        top = mod.split('.')[0]
        assert top not in ('jax', 'jaxlib', 'prysm_tpu'), f'{path.name} imports {mod}'


def test_port_files_found():
    assert len(PORT_FILES) > 15
    assert len(TIER_FILES) == 7


def test_examples_match_the_jax_package():
    """prysm_tpu_torch/examples/ holds the JAX package's examples by name, and its
    package init."""
    want = {p.name for p in (ROOT / 'examples').glob('*.py')}
    got = {p.name for p in (ROOT / 'prysm_tpu_torch' / 'examples').glob('*.py')}
    assert len(want) == 5 and got == want | {'__init__.py'}


def _test_functions(path):
    return {node.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.FunctionDef) and node.name.startswith('test_')}


@pytest.mark.parametrize('path', TIER_FILES, ids=lambda p: p.name)
def test_card_tier_answers_to_the_tpu_tier(path):
    """Each card-tier file has a counterpart of every test function of its
    tests_tpu/ file, by name, and no test of its own; the seven hold all 43."""
    tpu = ROOT / 'tests_tpu' / path.name.replace('test_torch_chip_', 'test_tpu_')
    assert _test_functions(path) == _test_functions(tpu)
    assert sum(len(_test_functions(p)) for p in TIER_FILES) == 43


def test_slice9_modules_match_the_jax_package():
    """x/optym and x/coatings hold the JAX package's module names, and import no matplotlib."""
    import subprocess
    for pkg in ('optym', 'coatings'):
        want = {p.name for p in (ROOT / 'prysm_tpu' / 'x' / pkg).glob('*.py')}
        got = {p.name for p in (ROOT / 'prysm_tpu_torch' / 'x' / pkg).glob('*.py')}
        assert got == want, (pkg, want ^ got)
    code = ('import sys, prysm_tpu_torch.x.optym, prysm_tpu_torch.x.coatings; '
            'assert "matplotlib" not in sys.modules and "jax" not in sys.modules')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)


# the optics-core modules of the cfg3/cfg4 slice: each is one of the files the
# import check above reads, and imports without a card
SLICE5_MODULES = ('mathops', 'coordinates', 'geometry', 'otf', 'segmented', 'fttools', 'psf',
                  'propagation.dft', 'propagation.angular_spectrum', 'propagation.wavefront',
                  'propagation.coronagraph', 'steps', 'interop')


# the polynomial families and the image-simulation modules of the freeform /
# image-chain slice
SLICE6_MODULES = tuple(f'polynomials.{m}' for m in (
    '_recurrence', '_clenshaw', 'jacobi', 'cheby', 'legendre', 'hermite', 'laguerre', 'dickson',
    'xy', 'zernike', 'fitting', 'qpoly')) + ('objects', 'degradations', 'degredations',
                                             'convolution', 'conf')


# the glass models and the sequential raytracer core of the cfg6 slice
SLICE7_MODULES = ('x', 'x.materials', 'x.materials.formulas', 'x.materials.core',
                  'x.materials.lookup') + tuple(f'x.raytracing.{m}' for m in (
                      '__init__', 'spencer_and_murty', 'sagjets', 'sags', 'intersections',
                      'aperture', 'opl', 'surfaces', '_line_math', '_meta', '_resolve', '_cache',
                      'paraxial', 'lensdata', 'opt', 'raygen', 'launch', '_trace_grid',
                      '_namespaces', 'system', 'batch'))


# the rest of the optics core and phase-shifting interferometry: the
# interferometer-analysis slice
SLICE8_MODULES = ('util', 'wavelengths', 'refractive', 'plotting', '_richdata', 'io',
                  'interferogram', 'thinlens', 'thinfilm', 'profiling', 'sample_data', 'x.psi')


# optym and coatings: the coating designer's and the L-BFGS-B phase retrieval's slice
SLICE9_MODULES = ('x.optym', 'x.coatings') + tuple(f'x.optym.{m}' for m in (
    'problem', 'governors', 'linesearch', 'lbfgsb', 'optimizers', 'least_squares', 'checkpoint',
    'cost', 'activation', 'operators', 'sample_problems', 'plotting')) + tuple(
    f'x.coatings.{m}' for m in ('stack', 'diff', 'merit', 'problem', 'refine', 'needle',
                                'monitoring', 'rugate', 'common_materials', 'plotting'))


# the rest of x/materials and the six small instruments: the wavefront-control slice
SLICE10_MODULES = tuple(f'x.materials.{m}' for m in (
    'tabulated', 'charms', 'catalog', 'registry', 'transforms', 'infrared', 'agf', 'rii',
    'fitted')) + tuple(f'x.{m}' for m in ('polarization', 'fibers', 'sri', 'pdi', 'dm',
                                          'shack_hartmann'))


# the analysis cluster of x/raytracing: the lens-analysis slice
SLICE11_MODULES = tuple(f'x.raytracing.{m}' for m in (
    'listings', 'sample_rx', 'sensitivity', 'auto', 'aberrations', '_diff_raytrace',
    'parabasal', 'analysis', 'adjoint', 'adjoint.seeds', 'adjoint.primitives',
    'adjoint.engine', 'adjoint.tolerance_analysis'))


# design, tolerancing, pupil fields and prescription IO: the lens designer's slice
SLICE12_MODULES = tuple(f'x.raytracing.{m}' for m in (
    'design', 'tolerance', 'wavefront_differential', 'field', 'io', 'io._indexing',
    'io._common', 'io._surface_spec', 'io.zemax', 'io.codev'))


# the mesh patterns over torch.distributed and the raytracing plots
SLICE13_MODULES = ('parallel', 'parallel._collectives', 'parallel.mesh', 'parallel.sharding',
                   'parallel.coronagraph', 'parallel.mdft_contraction', 'parallel.fft',
                   'parallel.raytrace', 'parallel.overlap', 'x.raytracing.plotting')


# the JAX package's examples, the port's user entry points
SLICE14_MODULES = ('examples',) + tuple(f'examples.{m}' for m in (
    'lowfs_realtime', 'coronagraph_dark_hole', 'phase_retrieval', 'lens_design',
    'coating_design'))


def _module_path(module):
    path = ROOT / 'prysm_tpu_torch' / (module.replace('.', '/') + '.py')
    return path if path.exists() else path.with_suffix('') / '__init__.py'


@pytest.mark.parametrize('module', SLICE5_MODULES + SLICE6_MODULES + SLICE7_MODULES
                         + SLICE8_MODULES + SLICE9_MODULES + SLICE10_MODULES
                         + SLICE11_MODULES + SLICE12_MODULES + SLICE13_MODULES
                         + SLICE14_MODULES)
def test_slice_module_is_checked_and_imports(module):
    import importlib
    path = _module_path(module)
    assert path in PORT_FILES
    importlib.import_module(f'prysm_tpu_torch.{module}'.removesuffix('.__init__'))


def test_slice10_modules_match_the_jax_package():
    """x/ and x/materials hold every module of the JAX package's but raytracing's; the
    materials import neither yaml (rii reads it when called) nor torch's card."""
    for sub in ('x', 'x/materials'):
        want = {p.name for p in (ROOT / 'prysm_tpu' / sub).glob('*.py')}
        got = {p.name for p in (ROOT / 'prysm_tpu_torch' / sub).glob('*.py')}
        assert got == want, (sub, want ^ got)
    code = ('import sys, prysm_tpu_torch.x.materials, prysm_tpu_torch.x.dm, '
            'prysm_tpu_torch.x.polarization, prysm_tpu_torch.x.sri, prysm_tpu_torch.x.pdi, '
            'prysm_tpu_torch.x.shack_hartmann; '
            'assert "yaml" not in sys.modules and "jax" not in sys.modules')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)


def _cfg6_on_cpu(monkeypatch):
    from prysm_tpu_torch import steps
    from prysm_tpu_torch.conf import config
    monkeypatch.setattr(config, '_device', 'cpu')
    return steps.cfg6_system()


@pytest.mark.parametrize('verb, item', [(lambda s: s.plot.spots(), '21c')])
def test_unported_verbs_raise_naming_the_roadmap_item(monkeypatch, verb, item):
    """No verb raises for an unported ROADMAP item any more: the last ones, of
    ``plotting`` (item 21c), draw; and no module of the port keeps a ``not_ported``."""
    import matplotlib
    matplotlib.use('Agg')
    from matplotlib import pyplot as plt
    system = _cfg6_on_cpu(monkeypatch)
    fig, axs = verb(system)
    plt.close(fig)
    assert axs.shape == (1, len(system.fields))
    assert not [path for path in PORT_FILES if 'not_ported' in path.read_text()], item


def _design_verb_runs(pkg):
    """system.opt.problem, system.tol.monte_carlo and system.tol.wavefront on cfg6
    through ``pkg`` (the JAX package's or the port's raytracing): host float64 results."""
    import importlib
    from prysm_tpu_torch import steps
    rt = importlib.import_module(f'{pkg}.x.raytracing')
    mat = importlib.import_module(f'{pkg}.x.materials')
    lens = rt.LensData()
    media = [mat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, media + [mat.air]):
        lens.add(rt.Sphere(c), thickness=t, material=m)
    system = rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(steps.CFG6_EPD),
                              fields=list(steps.CFG6_FIELDS), wavelengths=[steps.WVL],
                              stop_index=steps.CFG6_STOP)
    system.opt.vary('curvature', [1, 2, 3])
    prob = system.opt.problem('spot', sampling=rt.Sampling.hex(3))
    perts = [rt.Perturbation.normal(system, 'curvature', 1, 2e-5, name='c1'),
             rt.Perturbation.normal(system, 'thickness', 2, 0.02, name='t2')]
    jrt = importlib.import_module('prysm_tpu.x.raytracing')
    P, S = (np.asarray(a) for a in jrt.launch(system, system.field(2), steps.WVL,
                                              jrt.Sampling.hex(3)))
    spot = rt.RmsSpotRadius()

    def merit(s):
        return spot.value(s.trace(P, S, steps.WVL), s, steps.WVL)

    return {'problem': prob.residuals(prob.x0()),
            'monte_carlo': system.tol.monte_carlo(perts, merit, 4, seed=3).merits,
            'wavefront': system.tol.wavefront(perts, P, S).dW}


@pytest.mark.parametrize('verb', ['problem', 'monte_carlo', 'wavefront'])
def test_design_verbs_run_and_match_the_jax_package(monkeypatch, verb):
    """The verbs of ``design``, ``tolerance`` and ``wavefront_differential`` (ROADMAP
    item 21b, ported) run on the CPU and give the JAX package's float64 results."""
    import torch
    import jax
    from prysm_tpu_torch.conf import config
    jax.config.update('jax_enable_x64', True)
    monkeypatch.setattr(config, '_device', 'cpu')
    monkeypatch.setattr(config, '_precision', torch.float64)
    from _jax_refs import jax_ref
    got = _design_verb_runs('prysm_tpu_torch')[verb]
    want = jax_ref('design-verbs', _design_verb_runs, 'prysm_tpu', bar=1e-10)[verb]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_slice11_modules_match_the_jax_package():
    """x/raytracing holds every module of the JAX package's (``plotting``, ROADMAP item
    21c, included), and tolerance_analysis imports pandas only when asked for a DataFrame;
    the raytracing package imports no matplotlib."""
    want = {p.relative_to(ROOT / 'prysm_tpu').as_posix()
            for p in (ROOT / 'prysm_tpu' / 'x' / 'raytracing').rglob('*.py')}
    got = {p.relative_to(ROOT / 'prysm_tpu_torch').as_posix()
           for p in (ROOT / 'prysm_tpu_torch' / 'x' / 'raytracing').rglob('*.py')}
    assert got == want
    code = ('import sys, prysm_tpu_torch.x.raytracing.adjoint; '
            'assert "pandas" not in sys.modules and "jax" not in sys.modules '
            'and "matplotlib" not in sys.modules')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)


def test_slice13_modules_match_the_jax_package():
    """parallel/ holds every module of the JAX package's and exports its names but the two
    HLO readers of ``overlap``; the whole package now mirrors the JAX package's files but
    ``ops/dispatch.py`` (the port has no mode switch)."""
    import prysm_tpu_torch.parallel as par
    import prysm_tpu_torch.parallel.overlap as overlap
    want = {p.name for p in (ROOT / 'prysm_tpu' / 'parallel').glob('*.py')}
    got = {p.name for p in (ROOT / 'prysm_tpu_torch' / 'parallel').glob('*.py')}
    assert got - {'_collectives.py'} == want
    init = ast.parse((ROOT / 'prysm_tpu' / 'parallel' / '__init__.py').read_text())
    names = {alias.name for node in ast.walk(init) if isinstance(node, ast.ImportFrom)
             for alias in node.names}
    assert len(names) == 19 and not [n for n in names if not hasattr(par, n)]
    assert overlap.__all__ == ['overlapped_spectral_grad']
    jax_files = {p.relative_to(ROOT / 'prysm_tpu').as_posix()
                 for p in (ROOT / 'prysm_tpu').rglob('*.py')}
    port_files = {p.relative_to(ROOT / 'prysm_tpu_torch').as_posix()
                  for p in (ROOT / 'prysm_tpu_torch').rglob('*.py')}
    assert jax_files - port_files == {'ops/dispatch.py'}


def test_ported_solves_run_on_the_cpu(monkeypatch):
    """The solve verbs of the ported launch module trace on config.device."""
    system = _cfg6_on_cpu(monkeypatch)
    system.solve.apertures(wavelength=0.55)
    extents = [row.aperture.extent for row in system.rows]
    assert any(e is not None and e.outer_radius > 9.0 for e in extents)


@pytest.mark.parametrize('kind', ['czt', 'fftdft'])
def test_prepare_executor_builds_the_other_kinds(kind):
    import torch
    from prysm_tpu_torch import fttools
    from prysm_tpu_torch.propagation import prepare_executor
    plan = prepare_executor(0.015625, 16, 0.5, 12, 0.5, 10.0, kind=kind, device='cpu')
    assert isinstance(plan, {'czt': fttools.CZT, 'fftdft': fttools.FFTDFT}[kind])
    assert plan(torch.ones(16, 16)).shape == (12, 12)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def _no_result(proc):
    for line in proc.stdout.splitlines():
        try:
            assert not json.loads(line).get('ok')
        except (ValueError, AttributeError):
            pass


def test_chip_smoke_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: chip_smoke.py runs for real here')
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    _no_result(proc)
    # alone in a directory, without the package beside it
    (tmp_path / 'chip_smoke.py').write_text((ROOT / 'chip_smoke.py').read_text())
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    _no_result(alone)
