"""Tabular LensData listings: surfaces, apertures, coordinate breaks.

Counterpart of ``prysm_tpu/x/raytracing/listings.py``.  Rendering is
driven by a shared column-spec table formatter (:class:`_Listing`); the
three listing types differ only in their columns and row extractors.
"""
from .spencer_and_murty import (STYPE_EVAL, STYPE_IMG, STYPE_OBJ,
                                STYPE_REFLECT, STYPE_REFRACT)
from .surfaces import _map_stype
from .aperture import CircularClip, AnnularClip
from ..materials import air, vacuum, MIRROR
from .lensdata import CoordBreak, SurfaceMap

_TYPE_LABELS = {STYPE_REFRACT: 'refr', STYPE_REFLECT: 'refl',
                STYPE_EVAL: 'eval', STYPE_OBJ: 'object', STYPE_IMG: 'image'}


def _radius_label(curvature):
    curvature = float(curvature)
    return 'inf' if curvature == 0.0 else f'{1.0 / curvature:.6g}'


def material_str(material, typ):
    """Display label for a row's material."""
    mirror_like = (_map_stype(typ) == STYPE_REFLECT or material is MIRROR
                   or material == MIRROR)
    if mirror_like:
        return 'MIRROR'
    if material is None or material in (air, vacuum):
        return ''
    return str(getattr(material, 'name', None) or material)


def surface_row_mappings(lensdata):
    """Per-row dicts tying row index to compiled-surface index."""
    return SurfaceMap(lensdata).records()


class _Listing:
    """Shared fixed-width table renderer over per-row record dicts.

    Subclasses declare ``title`` and ``columns`` — (header, width, render)
    triples where render maps a record to its cell string.
    """

    title = 'Listing'
    columns = ()

    def __init__(self, records):
        self.records = list(records)

    def _caption(self):
        return self.title

    def _head(self):
        return '  ' + ' '.join(f'{h:>{w}s}' for h, w, _ in self.columns)

    def __repr__(self):
        head = self._head()
        out = [self._caption(), head, '  ' + '-' * (len(head) - 2)]
        for rec in self.records:
            cells = ' '.join(f'{render(rec):>{w}s}'
                             for _, w, render in self.columns)
            out.append('  ' + cells)
        return '\n'.join(out)


def _g6(value):
    return f'{value:.6g}'


class SurfaceTable(_Listing):
    """Lens-data-editor table."""

    title = 'SurfaceTable'
    columns = (
        ('#', 3, lambda r: str(r['index'])),
        ('', 1, lambda r: '*' if r['stop'] else ' '),
        ('type', 6, lambda r: r['type']),
        ('radius', 12, lambda r: r['radius']),
        ('conic', 10, lambda r: r['conic']),
        ('thickness', 12, lambda r: _g6(r['thickness'])),
        ('material', 10, lambda r: r['material']),
        ('semidia', 10, lambda r: ('' if r['semidiameter'] is None
                                   else _g6(r['semidiameter']))),
        ('coat', 5, lambda r: 'Y' if r.get('coating') else ''),
    )

    def __init__(self, records, unit=None, stop_index=None):
        super().__init__(records)
        self.unit, self.stop_index = unit, stop_index

    def _caption(self):
        return self.title + (f' [{self.unit}]' if self.unit else '')


class ApertureTable(_Listing):
    """Per-surface aperture table."""

    title = 'ApertureTable'
    columns = (
        ('#', 3, lambda r: str(r['index'])),
        ('clip', 18, lambda r: r['clip']),
        ('drawn', 12, lambda r: ('' if r['drawn'] is None
                                 else _g6(r['drawn']))),
        ('provenance', 10, lambda r: r['provenance']),
        ('stale', 6, lambda r: 'stale' if r['stale'] else ''),
    )

    def __init__(self, records, version=None):
        super().__init__(records)
        self.version = version  # LensData edit counter the rows reflect


class DecenterTable(_Listing):
    """Coordinate-break table."""

    title = 'DecenterTable'
    columns = (
        ('#', 3, lambda r: str(r['index'])),
        *((axis, 9, lambda r, a=axis: f'{r[a]:.4g}')
          for axis in ('dx', 'dy', 'dz', 'rz', 'ry', 'rx')),
        ('kind', 7, lambda r: r['kind']),
    )

    def __repr__(self):
        if self.records:
            return super().__repr__()
        return 'DecenterTable (no coordinate breaks)' 


def _shape_radius_conic(shape):
    """Canonical (curvature, conic) pulled from the shape's tagged DOFs."""
    params = shape.params or {}
    spec = getattr(shape, 'spec', None)

    def last_of(*tags):
        keys = spec.tagged(*tags) if spec is not None else ()
        return params.get(keys[-1], 0.0) if keys else 0.0

    return last_of('radius', 'curvature'), last_of('conic')


def _surface_record(base, row):
    if isinstance(row, CoordBreak):
        return {**base, 'type': f'CB:{row.kind}', 'radius': '', 'conic': '',
                'material': '', 'semidiameter': None, 'coating': False}
    c, k = _shape_radius_conic(row.build_shape())
    return {**base,
            'type': _TYPE_LABELS.get(_map_stype(row.typ), str(row.typ)),
            'radius': _radius_label(c),
            'conic': f'{float(k):.6g}',
            'material': material_str(row.material, row.typ),
            'semidiameter': _clip_radius(row.aperture),
            'coating': getattr(row, 'coating', None) is not None}


def surface_table(lensdata, *, stop_index=None, unit=None):
    """Render a LensData into its lens-data-editor surface table."""
    records = [
        _surface_record({'index': mapping['row_index'],
                         'surface_index': mapping['surface_index'],
                         'stop': (stop_index is not None
                                  and mapping['surface_index'] == stop_index),
                         'thickness': float(row.thickness)}, row)
        for mapping, row in zip(surface_row_mappings(lensdata), lensdata.rows)
    ]
    return SurfaceTable(records, unit=unit, stop_index=stop_index)


def _clip_radius(aperture):
    limit = aperture.limiting_radius()
    return None if limit is None else float(limit)


def _clip_label(clip):
    if clip is None:
        return ''
    if isinstance(clip, CircularClip):
        return f'circular {clip.radius:.6g}'
    if isinstance(clip, AnnularClip):
        return (f'annular {clip.inner_radius:.4g}'
                f'-{clip.outer_radius:.4g}')
    return type(clip).__name__


def aperture_table(lensdata):
    """Render a LensData into its per-surface aperture table."""
    version = lensdata._version
    records = [
        {'index': i, 'clip': _clip_label(row.aperture.clip),
         'drawn': row.aperture.drawn_radius(),
         'provenance': 'auto' if row.aperture.is_auto else 'user',
         'stale': row.aperture.is_stale(version)}
        for i, row in enumerate(lensdata.rows)
        if not isinstance(row, CoordBreak)
    ]
    return ApertureTable(records, version=version)


def decenter_table(lensdata):
    """Render a LensData's coordinate breaks as a decenter/tilt table."""
    records = [
        {'index': i, 'kind': row.kind,
         **dict(zip(('dx', 'dy', 'dz'), map(float, row.decenter))),
         **dict(zip(('rz', 'ry', 'rx'), map(float, row.tilt)))}
        for i, row in enumerate(lensdata.rows) if isinstance(row, CoordBreak)
    ]
    return DecenterTable(records)


__all__ = ['surface_table', 'aperture_table', 'decenter_table',
           'ApertureTable', 'DecenterTable', 'SurfaceTable', 'material_str']
