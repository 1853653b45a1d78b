"""The JAX package's outputs for the port's parity tests, recorded once and read back.

``jax_ref(key, compute, *inputs)`` returns what ``compute(*inputs)`` returns:
arrays (as host numpy arrays), scalars, strings, None, slices, and tuples,
lists and dicts of these; or it raises the type and message that ``compute`` raised.
The value comes from ``tests/jax_refs/<test module>.npz`` where that file's
stamp is the tree's and it holds the record, and from calling ``compute``
otherwise.  A miss is slower, never different: the live value goes through the
same encoding as a record.

A record is found by ``key`` and by a hash of the inputs' bytes and of
``compute``'s code, with the code of the repo's functions and test classes it
names and the values of the module-level names (and the repo's module
attributes, ``steps.CFG6_EPD``) they read; so a record answers only the call
that made it.  The stamp is a sha256 over ``prysm_tpu/**/*.py``, the files the
records read (``reads``, paths from the repo's root), and the Python, jax and
numpy versions.  The JAX package is frozen, so its outputs on fixed inputs
are constants.  ``bar`` is the bar the test holds the value to (one number, or
a number a part in a tuple, list or dict shaped as the value): the recorder
keeps a record only where two recordings (native and AVX2) agree to 1/100 of
it, and exactly in every integer, string and shape.

Nothing here writes.  ``tests/record_jax_refs.py`` is the only writer: it sets
``CAPTURE`` (every live call is kept there) or ``READ`` (every record returned
is noted there).
"""
import functools
import hashlib
import importlib
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
RECORDS = ROOT / 'tests' / 'jax_refs'

CAPTURE = None
READ = None


def jax_ref(key, compute, *inputs, bar=0.0, reads=()):
    """``compute(*inputs)``, from its record where the record is current."""
    module = _test_module()
    rid = f'{key}@{digest(compute, inputs)[:16]}'
    book = {} if CAPTURE is not None else _book(module)
    if rid in book:
        if READ is not None:
            READ.add((module, rid))
        return decode(*book[rid])
    start = time.perf_counter()
    try:
        out = compute(*inputs)
    except Exception as exc:
        if CAPTURE is not None:
            tree = {'raises': f'{type(exc).__module__}.{type(exc).__qualname__}',
                    'message': str(exc)}
            CAPTURE[module, rid] = (tree, [], bar, tuple(reads), time.perf_counter() - start)
        raise
    tree, leaves = encode(out)
    if CAPTURE is not None:
        CAPTURE[module, rid] = (tree, leaves, bar, tuple(reads), time.perf_counter() - start)
    return decode(tree, leaves)


def _test_module():
    frame = sys._getframe(2)
    while frame is not None:
        name = Path(frame.f_code.co_filename).name
        if name.startswith('test_') and name.endswith('.py'):
            return name[:-3]
        frame = frame.f_back
    raise RuntimeError('jax_ref is called from a test module')


# ---------------------------------------------------------------------------
# the stamp and the record files
# ---------------------------------------------------------------------------

@functools.cache
def _package_hash():
    h = hashlib.sha256()
    for path in sorted((ROOT / 'prysm_tpu').rglob('*.py')):
        h.update(path.relative_to(ROOT).as_posix().encode() + b'\0' + path.read_bytes())
    return h.hexdigest()


def stamp(reads):
    """The stamp of the tree for records that read the files ``reads``."""
    import jax
    h = hashlib.sha256(_package_hash().encode())
    for rel in sorted(set(reads)):
        h.update(rel.encode() + b'\0' + (ROOT / rel).read_bytes())
    h.update(f'python {sys.version_info[:2]} jax {jax.__version__} '
             f'numpy {np.__version__}'.encode())
    return h.hexdigest()


def load(module):
    """(stamp, reads, {rid: (tree, leaves)}) of a record file."""
    with np.load(RECORDS / f'{module}.npz', allow_pickle=False) as f:
        data = {k: f[k] for k in f.files}
    meta = json.loads(str(data.pop('__meta__')))
    records = {}
    for rid, n in meta['records'].items():
        records[rid] = (json.loads(str(data[rid])), [data[f'{rid}.{i}'] for i in range(n)])
    return meta['stamp'], meta['reads'], records


@functools.cache
def _book(module):
    if not (RECORDS / f'{module}.npz').exists():
        return {}
    recorded, reads, records = load(module)
    try:
        current = stamp(reads)
    except OSError:
        return {}
    return records if recorded == current else {}


def save(module, records):
    """Write ``{rid: (tree, leaves, reads)}`` as ``tests/jax_refs/<module>.npz``."""
    reads = sorted({r for _, _, rs in records.values() for r in rs})
    meta = {'stamp': stamp(reads), 'reads': reads,
            'records': {rid: len(leaves) for rid, (_, leaves, _) in sorted(records.items())}}
    arrays = {'__meta__': np.asarray(json.dumps(meta))}
    for rid, (tree, leaves, _) in records.items():
        arrays[rid] = np.asarray(json.dumps(tree))
        arrays.update({f'{rid}.{i}': leaf for i, leaf in enumerate(leaves)})
    RECORDS.mkdir(exist_ok=True)
    np.savez_compressed(RECORDS / f'{module}.npz', **arrays)


# ---------------------------------------------------------------------------
# values as a JSON tree and a list of arrays
# ---------------------------------------------------------------------------

def encode(x):
    leaves = []

    def enc(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, complex):
            return {'c': [v.real, v.imag]}
        if isinstance(v, slice):
            return {'slice': [enc(v.start), enc(v.stop), enc(v.step)]}
        if isinstance(v, np.generic):
            leaves.append(np.asarray(v))
            return {'s': len(leaves) - 1}
        if isinstance(v, tuple):
            return {'t': [enc(e) for e in v]}
        if isinstance(v, list):
            return [enc(e) for e in v]
        if isinstance(v, dict):
            return {'d': [[enc(k), enc(e)] for k, e in v.items()]}
        if isinstance(v, np.ndarray) or hasattr(v, '__array__') and not torch.is_tensor(v):
            a = np.asarray(v)
            if a.dtype.hasobject:
                raise TypeError(f'jax_ref cannot record an object array: {a!r}')
            leaves.append(np.array(a))
            return {'a': len(leaves) - 1}
        raise TypeError(f'jax_ref cannot record a {type(v).__name__}')

    return enc(x), leaves


def decode(tree, leaves):
    if isinstance(tree, dict) and 'raises' in tree:
        module, _, name = tree['raises'].rpartition('.')
        raise getattr(importlib.import_module(module), name)(tree['message'])

    def dec(v):
        if isinstance(v, list):
            return [dec(e) for e in v]
        if not isinstance(v, dict):
            return v
        if 'c' in v:
            return complex(*v['c'])
        if 'slice' in v:
            return slice(*map(dec, v['slice']))
        if 's' in v:
            return leaves[v['s']][()]
        if 'a' in v:
            return leaves[v['a']].copy()
        if 't' in v:
            return tuple(dec(e) for e in v['t'])
        return {dec(k): dec(e) for k, e in v['d']}

    return dec(tree)


# ---------------------------------------------------------------------------
# the hash of a call
# ---------------------------------------------------------------------------

def digest(compute, inputs):
    """sha256 of ``compute``'s code and of the inputs' bytes."""
    h = hashlib.sha256()
    _feed(h, compute, set(), strict=True)
    _feed(h, inputs, set(), strict=True)
    return h.hexdigest()


def _ours(path):
    """A file of this repo outside the JAX package (whose sources the stamp holds)."""
    path = Path(path or '')
    return path.is_relative_to(ROOT) and not path.is_relative_to(ROOT / 'prysm_tpu')


def _in_tests(cls):
    """A class of a test module (whose methods ``_feed`` hashes)."""
    path = getattr(sys.modules.get(cls.__module__), '__file__', None)
    return path is not None and Path(path).parent == ROOT / 'tests'


def _feed(h, x, seen, strict=False):
    """Feed ``x`` to ``h``: data by value, the repo's functions by code and by the values
    they read.  An input of another kind raises (``strict``); a global of another kind
    feeds its type's name."""
    tag = type(x).__qualname__.encode() + b'\0'
    h.update(tag)
    if x is None or isinstance(x, (bool, int, float, complex, str, bytes)):
        h.update(repr(x).encode())
    elif isinstance(x, (np.ndarray, np.generic)) or torch.is_tensor(x):
        a = np.ascontiguousarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)
        if a.dtype.hasobject:
            raise TypeError('jax_ref cannot hash an object array')
        h.update(f'{a.dtype.str}{a.shape}'.encode() + a.tobytes())
    elif isinstance(x, (set, frozenset)):
        h.update(repr(sorted(map(repr, x))).encode())
    elif isinstance(x, (tuple, list)):
        h.update(str(len(x)).encode())
        for e in x:
            _feed(h, e, seen, strict)
    elif isinstance(x, dict):
        h.update(str(len(x)).encode())
        for k, v in x.items():
            _feed(h, k, seen, strict)
            _feed(h, v, seen, strict)
    elif isinstance(x, types.ModuleType):
        h.update(x.__name__.encode())
    elif isinstance(x, type) and x not in seen and _in_tests(x):
        seen.add(x)
        h.update(x.__qualname__.encode())
        _feed(h, [v for k, v in vars(x).items() if isinstance(v, (
            types.FunctionType, staticmethod, classmethod)) or not k.startswith('__')], seen)
    elif isinstance(x, (type, types.BuiltinFunctionType)):
        h.update(f'{x.__module__}.{x.__qualname__}'.encode())
    elif isinstance(x, functools.partial):
        _feed(h, (x.func, x.args, x.keywords), seen, strict)
    elif hasattr(x, '__wrapped__'):
        _feed(h, x.__wrapped__, seen, strict)
    elif isinstance(x, types.FunctionType):
        h.update(f'{x.__module__}.{x.__qualname__}'.encode())
        if _ours(x.__code__.co_filename) and x not in seen:
            seen.add(x)
            _feed(h, (x.__defaults__, x.__kwdefaults__), seen, strict)
            for cell in x.__closure__ or ():
                _feed(h, cell.cell_contents, seen)
            _feed_code(h, x.__code__, x.__globals__, seen)
    elif strict:
        raise TypeError(f'jax_ref cannot hash an input of type {type(x).__name__}')


def _feed_code(h, code, names, seen):
    h.update(code.co_code + repr(code.co_names).encode())
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _feed_code(h, c, names, seen)
        else:
            _feed(h, c, seen)
    for name in code.co_names:
        if name in names:
            value = names[name]
            _feed(h, value, seen)
            if isinstance(value, types.ModuleType) and _ours(getattr(value, '__file__', None)):
                for attr in code.co_names:
                    if attr in vars(value):
                        _feed(h, vars(value)[attr], seen)
