"""Carry state from the JAX package into the port.

The functions here take the JAX package's state as numpy arrays (what
``numpy.asarray`` gives for a JAX array) and return the port's objects,
so both packages can compute on the same plan and inputs.  Nothing here
imports JAX.
"""
import numpy as np
import torch

from .conf import resolve_device
from .detector import Detector
from .fttools import MDFT, CZT, FFTDFT
from .parallel import SpectralMDFT, StackedMultiRes
from .propagation import MultiResolutionExecutor
from .segmented import CompositeHexagonalAperture
from .steps import Pupil

__all__ = ['mdft_from_numpy', 'czt_from_numpy', 'fftdft_from_numpy', 'plan_from_numpy',
           'multiresolution_from_numpy', 'composite_aperture_from_numpy', 'pupil_from_numpy',
           'spectral_mdft_from_numpy', 'stacked_multires_from_numpy', 'detector_from_numpy',
           'surfaces_from_numpy', 'interferogram_from_numpy', 'scheme_from_numpy',
           'stack_from_numpy', 'optimizer_state_from_numpy', 'dm_from_numpy']


def _tensor(a, device, dtype=None):
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def mdft_from_numpy(Ex_re, Ex_im, Ey_re, Ey_im, norm, forward_left_first,
                    adjoint_left_first, pupil_dx=None, focal_dx=None,
                    matmul_precision=None, device=None):
    """An MDFT plan from the JAX plan's leaves (real and imaginary parts of Ex, Ey)."""
    dev = resolve_device(device)
    Ex = torch.complex(_tensor(Ex_re, dev), _tensor(Ex_im, dev))
    Ey = torch.complex(_tensor(Ey_re, dev), _tensor(Ey_im, dev))
    return MDFT(Ex, Ey, norm=norm, forward_left_first=forward_left_first,
                adjoint_left_first=adjoint_left_first, pupil_dx=pupil_dx,
                focal_dx=focal_dx, matmul_precision=matmul_precision)


def _complex_leaves(fields, names, dev):
    """{name: complex tensor} from the fields' name_re / name_im arrays."""
    return {n: torch.complex(_tensor(fields[n + '_re'], dev), _tensor(fields[n + '_im'], dev))
            for n in names}


def _statics(fields, names):
    return {n: fields[n] for n in names}


_CZT_LEAVES = ('brow', 'bcol', 'Hrow', 'Hcol', 'arow', 'acol', 'x_phase', 'y_phase')
_FFTDFT_LEAVES = ('pre_x', 'pre_y', 'post_x', 'post_y')
_GEOMETRY = ('norm', 'Nx', 'Ny', 'Mx', 'My', 'Kx', 'Ky', 'x_first', 'pupil_dx', 'focal_dx')


def czt_from_numpy(fields, device=None):
    """A CZT plan from the JAX plan's fields: {name: value} of its re/im leaves and statics."""
    dev = resolve_device(device)
    return CZT(**_complex_leaves(fields, _CZT_LEAVES, dev), **_statics(fields, _GEOMETRY))


def fftdft_from_numpy(fields, device=None):
    """An FFTDFT plan from the JAX plan's fields: {name: value} of its re/im leaves and statics."""
    dev = resolve_device(device)
    return FFTDFT(**_complex_leaves(fields, _FFTDFT_LEAVES, dev),
                  **_statics(fields, _GEOMETRY + ('x_direction', 'y_direction')))


def plan_from_numpy(fields, device=None):
    """An MDFT, CZT or FFTDFT plan from a JAX plan's fields, by the leaves they hold."""
    if 'Ex_re' in fields:
        return mdft_from_numpy(**fields, device=device)
    if 'brow_re' in fields:
        return czt_from_numpy(fields, device=device)
    return fftdft_from_numpy(fields, device=device)


def multiresolution_from_numpy(executors, windows, xf, yf, device=None):
    """A MultiResolutionExecutor from the JAX stack: its plans' fields and its host arrays.

    The windows and focal grids go to the device in the plans' real dtype.
    """
    dev = resolve_device(device)
    plans = [plan_from_numpy(f, device=dev) for f in executors]
    real = next(v for v in vars(plans[0]).values() if torch.is_tensor(v)).real.dtype
    host = lambda arrs: [_tensor(a, dev, real) for a in arrs]  # noqa: E731
    return MultiResolutionExecutor(plans, host(windows), host(xf), host(yf))


def composite_aperture_from_numpy(amp, windows, local_masks, opd_bases, segment_ids,
                                  device=None):
    """A CompositeHexagonalAperture that composes the JAX aperture's OPD.

    Takes the JAX aperture's ``amp``, ``windows`` (slice pairs),
    ``local_masks``, ``opd_bases`` and ``segment_ids``; the result's
    ``compose_opd`` runs the same slice-adds on the port's device.
    """
    dev = resolve_device(device)
    cha = CompositeHexagonalAperture.__new__(CompositeHexagonalAperture)
    cha.device = dev
    cha.amp = _tensor(amp, dev)
    cha.windows = list(windows)
    cha.local_masks = [_tensor(m, dev) for m in local_masks]
    cha.opd_bases = [_tensor(b, dev) for b in opd_bases]
    cha.segment_ids = [int(i) for i in segment_ids]
    return cha


def pupil_from_numpy(r, t, amp, dx, coefs, nms, device=None):
    """A ``steps.Pupil`` from the grids r, t, amp, the spacing, coefficients and (n, m) list."""
    dev = resolve_device(device)
    return Pupil(r=_tensor(r, dev), t=_tensor(t, dev), amp=_tensor(amp, dev),
                 dx=float(dx), coefs=_tensor(coefs, dev),
                 nms=tuple((int(n), int(m)) for n, m in nms))


def spectral_mdft_from_numpy(Ex_re, Ex_im, Ey_re, Ey_im, norm, pupil_dx, focal_dx,
                             device=None):
    """A ``parallel.SpectralMDFT`` from the JAX plan's leaves ((W, M, N) parts, (W, 1, 1) norm)."""
    dev = resolve_device(device)
    return SpectralMDFT(Ex=torch.complex(_tensor(Ex_re, dev), _tensor(Ex_im, dev)),
                        Ey=torch.complex(_tensor(Ey_re, dev), _tensor(Ey_im, dev)),
                        norm=_tensor(norm, dev), pupil_dx=pupil_dx, focal_dx=focal_dx)


def stacked_multires_from_numpy(Ex_re, Ex_im, Ey_re, Ey_im, norm, maskwin_re, maskwin_im,
                                device=None):
    """A ``parallel.StackedMultiRes`` from the JAX stack's leaves ((L, M, N) parts, (L,) norm)."""
    dev = resolve_device(device)

    def pair(re, im):
        return torch.complex(_tensor(re, dev), _tensor(im, dev))

    return StackedMultiRes(Ex=pair(Ex_re, Ex_im), Ey=pair(Ey_re, Ey_im), norm=_tensor(norm, dev),
                           maskwin=pair(maskwin_re, maskwin_im))


def detector_from_numpy(dark_current, read_noise, bias, fwc, conversion_gain, bits,
                        exposure_time, prnu=None, dcnu=None, lut=None, device=None):
    """A ``detector.Detector`` from the scalar parameters and optional prnu, dcnu, lut arrays."""
    dev = resolve_device(device)
    maps = [None if a is None else _tensor(a, dev) for a in (prnu, dcnu, lut)]
    return Detector(float(dark_current), float(read_noise), float(bias), float(fwc),
                    float(conversion_gain), int(bits), float(exposure_time), *maps)


def _material_from_row(spec):
    """None, a constant index, or (formula name, coefficients) as a material."""
    from .x.materials import ConstantMaterial, FormulaMaterial, formulas
    if spec is None:
        return None
    if isinstance(spec, (int, float, np.floating)):
        return ConstantMaterial(float(spec))
    name, coefs = spec
    return FormulaMaterial(name, getattr(formulas, name),
                           tuple(float(c) for c in np.ravel(coefs)))


def _clip_from_row(spec):
    """None, ('circular', r, x0, y0) or ('annular', r_in, r_out, x0, y0)."""
    from .x.raytracing.aperture import annular_aperture, circular_aperture
    if spec is None:
        return None
    kind, *vals = spec
    make = {'circular': circular_aperture, 'annular': annular_aperture}[kind]
    return make(*(float(v) for v in vals))


def _param_from_row(v):
    """Shape parameters as the JAX package's constructors hold them:
    numbers as Python floats (ints and bools kept), arrays as nested tuples."""
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return tuple(_param_from_row(x) for x in a)


def surfaces_from_numpy(rows, device=None, dtype=None):
    """The port's compiled surface list from a prescription flattened to numpy.

    Each row is a dict: ``kind`` (a shape kind of ``surfaces.SHAPE_MODELS``)
    and ``params`` (its parameter dict, numbers and arrays), ``P`` (3,) and
    ``R`` (3, 3) or None, ``interaction`` (an STYPE code or its name),
    ``material`` (None, a constant index, or (formula name in
    ``x.materials.formulas``, coefficients)), and ``clip`` (None,
    ``('circular', r, x0, y0)`` or ``('annular', r_in, r_out, x0, y0)``).
    Poses are kept on the host in ``dtype`` (default ``config.precision``)
    and their tensor copies made on ``device`` (default ``config.device``)
    once, here, so that a trace there reads them from the surface.
    """
    from .conf import config, precision_as
    from .x.raytracing.surfaces import Shape, Surface
    dev = resolve_device(device)
    dtype = config.precision if dtype is None else dtype
    out = []
    with precision_as(dtype):
        for row in rows:
            params = {k: _param_from_row(v) for k, v in row['params'].items()}
            interaction = row['interaction']
            if not isinstance(interaction, str):
                interaction = int(interaction)
            surf = Surface(Shape(row['kind'], params), interaction,
                           P=np.asarray(row['P'], dtype=np.float64),
                           R=None if row.get('R') is None else np.asarray(row['R']),
                           material=_material_from_row(row.get('material')),
                           aperture=_clip_from_row(row.get('clip')))
            surf.pose_like(torch.empty(0, dtype=dtype, device=dev))
            out.append(surf)
    return out


def interferogram_from_numpy(phase, dx, wavelength, intensity=None, meta=None, latcaled=None,
                             device=None):
    """An ``interferogram.Interferogram`` from a JAX Interferogram's state as numpy.

    ``phase`` keeps its dtype and goes to ``device`` (default
    ``config.device``); ``intensity`` and ``meta`` are kept as given, as the
    JAX package keeps them; ``latcaled`` is its ``_latcaled`` flag (by
    default the constructor's ``dx != 0``).
    """
    from .interferogram import Interferogram
    ifg = Interferogram(_tensor(phase, resolve_device(device)), dx=float(dx),
                        wavelength=wavelength, intensity=intensity, meta=meta)
    if latcaled is not None:
        ifg._latcaled = bool(latcaled)
    return ifg


def scheme_from_numpy(shifts, s, c):
    """An ``x.psi.Scheme`` from a JAX scheme's shifts, sine and cosine weights."""
    from .x.psi import Scheme
    return Scheme(np.asarray(shifts), np.asarray(s), np.asarray(c))


def stack_from_numpy(indices, thicknesses, substrate_index, ambient_index=1.0, device=None,
                     dtype=None):
    """An ``x.coatings.Stack`` from a JAX stack's layer indices and thicknesses as numpy.

    ``indices`` are the layers' numbers (or callables), ambient side first;
    ``thicknesses`` go to ``device`` (default ``config.device``) in ``dtype``
    (default ``config.precision``).
    """
    from .conf import config, precision_as
    from .x.coatings import Stack
    dtype = config.precision if dtype is None else dtype
    media = [v.item() if isinstance(v, np.generic) else v for v in indices]
    with precision_as(dtype):
        return Stack(media, _tensor(np.asarray(thicknesses), resolve_device(device), dtype),
                     substrate_index, ambient_index)


def optimizer_state_from_numpy(state, device=None):
    """The port's attribute values from an optym state the JAX package wrote.

    ``state`` is the dict of ``optimizer_state`` (name -> (tag, value)), or
    a whole ``save_checkpoint`` payload (its ``'state'`` is taken).  Arrays
    become tensors on ``device`` (default ``config.device``), keeping their
    dtype, except for the SciPy-driven ``LBFGSB``, whose driver buffers stay
    host numpy; tuples and lists of arrays keep their kind.  Returns
    {name: value}, ready for ``vars(optimizer).update(...)`` on an optimizer
    built with the same objective.
    """
    from .x.optym.checkpoint import FORMAT, _restore_value
    host = False
    if 'state' in state and 'format' in state:
        if state['format'] != FORMAT:
            raise ValueError(f"not an optym checkpoint payload: {state['format']!r}")
        host = state.get('optimizer_type') == 'LBFGSB'
        state = state['state']
    like = np.zeros(0) if host else torch.empty(0, device=resolve_device(device))
    return {name: _restore_value(tagged, like) for name, tagged in state.items()}


def dm_from_numpy(ifn, Nout, Nact, sep, shift=(0, 0), rot=(0, 0, 0), upsample=1,
                  actuators=None, dtype=None, device=None):
    """An ``x.dm.DM`` from the JAX DM's state: its influence function (``dm.ifn``), the
    lattice (Nout, Nact, sep), the shift, the rotation, the upsampling and the actuators.

    The DM works in ``dtype`` (default: the influence function's) on ``device``.
    """
    from .x.dm import DM
    ifn = _tensor(ifn, resolve_device(device), dtype)
    dm = DM(ifn, Nout, Nact=Nact, sep=sep, shift=shift, rot=rot, upsample=upsample)
    if actuators is not None:
        dm.update(_tensor(actuators, ifn.device, ifn.dtype))
    return dm
