"""Record the JAX package's outputs that the port's parity tests read (``tests/_jax_refs.py``).

    python tests/record_jax_refs.py [tests/test_torch_x.py ...]

With no files, every ``tests/test_torch_*.py`` that calls ``jax_ref`` or runs the
docs through ``_torch_docs.run_pair``.  The files' tests run twice in one process each,
both at once: as the CPU runs, and under ``XLA_FLAGS=--xla_cpu_max_isa=AVX2``.
A record is kept where the two agree exactly in every integer, string, shape
and raised error, and in every float to 1/100 of the record's ``bar`` (of the
peak), and while the records stay within 4 MB a file and 16 MB in all (the
records that save the most seconds a byte first); the others stay live and
are listed.  The kept records replace ``tests/jax_refs/<module>.npz`` of the
modules run.  Then the files' tests run
a third time, reading the records, and every record must be read back.
"""
import argparse
import os
import pickle
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

import _jax_refs as jr

ROOT = jr.ROOT
PYTEST = ['-q', '-m', 'not slow', '-p', 'no:cacheprovider', '-p', 'no:xdist',
          '-p', 'no:randomly']
FILE_BYTES, TOTAL_BYTES = 4e6, 16e6


def default_files():
    return sorted(str(p.relative_to(ROOT)) for p in (ROOT / 'tests').glob('test_torch_*.py')
                  if p.name != 'test_torch_jax_refs.py'
                  and ('jax_ref(' in p.read_text() or 'run_pair(' in p.read_text()))


def _child(mode, out, files):
    """Run the files' tests in this process, with ``CAPTURE`` (mode 'capture') or ``READ``
    (mode 'read') set; pickle what it collected, and pytest's exit code, to ``out``."""
    import pytest
    if mode == 'capture':
        jr.CAPTURE = {}
    else:
        jr.READ = set()
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    code = pytest.main(list(files) + PYTEST)
    with open(out, 'wb') as f:
        pickle.dump((int(code), jr.CAPTURE if mode == 'capture' else jr.READ), f)


def _spawn(mode, out, files, xla_flags=None):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('XLA_FLAGS', None)
    if xla_flags:
        env['XLA_FLAGS'] = xla_flags
    return subprocess.Popen([sys.executable, __file__, '--child', mode, out, *files],
                            cwd=ROOT, env=env)


def _gap(a, b, bar, at='value'):
    """Where and how two decoded recordings first differ beyond 1/100 of ``bar`` (a number,
    or a number a part in a tuple, list or dict shaped as the value), or None."""
    if isinstance(b, (list, tuple, dict)):
        if type(a) is not type(b) or len(a) != len(b) or (
                isinstance(b, dict) and list(a) != list(b)):
            return f'{at}: structure'
        keys = list(b) if isinstance(b, dict) else range(len(b))
        return next((g for g in (_gap(a[k], b[k], bar if np.isscalar(bar) else bar[k],
                                      f'{at}[{k!r}]') for k in keys) if g), None)
    if isinstance(b, (float, complex, np.ndarray, np.generic)) and not isinstance(b, bool):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return f'{at}: {a.dtype}{a.shape} against {b.dtype}{b.shape}'
        if not np.issubdtype(b.dtype, np.inexact):
            return None if np.array_equal(a, b) else f'{at}: integers'
        if not np.array_equal(np.isfinite(a), np.isfinite(b)) or not np.array_equal(
                a[~np.isfinite(b)], b[~np.isfinite(b)], equal_nan=True):
            return f'{at}: non-finite samples'
        fin = np.isfinite(b)
        if not fin.any():
            return None
        err = np.abs(a[fin] - b[fin]).max()
        scale = np.abs(b[fin]).max()
        return None if err <= bar / 100 * scale else (
            f'{at}: {err / max(scale, 1e-300):.3g} of peak, bar {bar:g}')
    return None if a == b else f'{at}: {a!r} against {b!r}'


def _bytes(record):
    """About the bytes a record takes in its compressed file."""
    return 256 + sum(len(zlib.compress(np.ascontiguousarray(a).tobytes())) for a in record[1])


def _within_limits(agreed, modules):
    """Of ``{(module, rid): record}``, the records kept within FILE_BYTES a file and
    TOTAL_BYTES in all (with the files of the modules not run), the most seconds saved a
    byte first; and those left out."""
    others = sum(p.stat().st_size for p in jr.RECORDS.glob('*.npz') if p.stem not in modules)
    sizes = {k: _bytes(rec) for k, rec in agreed.items()}
    used, total, kept, left = {}, others, {}, []
    for k in sorted(agreed, key=lambda k: agreed[k][4] / sizes[k], reverse=True):
        module = k[0]
        if (used.get(module, 0) + sizes[k] <= 0.95 * FILE_BYTES
                and total + sizes[k] <= 0.95 * TOTAL_BYTES):
            used[module] = used.get(module, 0) + sizes[k]
            total += sizes[k]
            kept[k] = agreed[k]
        else:
            left.append((*k, f'{sizes[k] / 1e6:.2f} MB over the size limits'))
    return kept, left


def _decoded(record):
    tree, leaves = record[:2]
    try:
        return jr.decode(tree, leaves)
    except Exception as exc:
        return (type(exc), str(exc))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('files', nargs='*')
    parser.add_argument('--child', nargs=2, metavar=('MODE', 'OUT'), help=argparse.SUPPRESS)
    args = parser.parse_args()
    files = args.files or default_files()
    if args.child:
        return _child(*args.child, files)

    with tempfile.TemporaryDirectory() as tmp:
        outs = {name: os.path.join(tmp, name) for name in ('native', 'avx2', 'read')}
        runs = [_spawn('capture', outs['native'], files),
                _spawn('capture', outs['avx2'], files, '--xla_cpu_max_isa=AVX2')]
        codes = [p.wait() for p in runs]
        (code_n, native), (code_a, avx2) = (pickle.load(open(outs[k], 'rb'))
                                            for k in ('native', 'avx2'))
        print(f'capture runs: pytest exit {code_n} (native), {code_a} (AVX2); '
              f'process exit {codes}')
        if max(code_n, code_a, *codes) > 1:
            print('a capture run did not run its tests through: nothing written')
            return 1

        agreed, live = {}, []
        for (module, rid), record in sorted(native.items()):
            other = avx2.get((module, rid))
            gap = 'not made under AVX2' if other is None else _gap(
                _decoded(other), _decoded(record), record[2])
            if gap:
                live.append((module, rid, gap))
            else:
                agreed[module, rid] = record
        modules = {Path(f).stem for f in files}
        within, left = _within_limits(agreed, modules)
        live += left
        kept = {}
        for (module, rid), record in within.items():
            kept.setdefault(module, {})[rid] = (record[0], record[1], record[3])
        for module in sorted(modules):
            path = jr.RECORDS / f'{module}.npz'
            if module in kept:
                jr.save(module, kept[module])
            elif path.exists():
                path.unlink()

        code_r = _spawn('read', outs['read'], files).wait()
        code_r, read = pickle.load(open(outs['read'], 'rb'))

    wrote = {(m, rid) for m, records in kept.items() for rid in records}
    seconds = sorted(((rec[4], m, rid) for (m, rid), rec in native.items()), reverse=True)
    print(f'{len(wrote)} records kept in {len(kept)} files, '
          f'{sum((jr.RECORDS / f"{m}.npz").stat().st_size for m in kept) / 1e6:.2f} MB; '
          f'live time recorded {sum(s for s, *_ in seconds):.1f} s')
    for s, m, rid in seconds[:15]:
        print(f'  {s:7.2f} s  {m}  {rid}')
    for module, rid, gap in live:
        print(f'live: {module} {rid} ({native[module, rid][4]:.1f} s): {gap}')
    unread = sorted(wrote - read)
    for module, rid in unread:
        print(f'not read back: {module} {rid}')
    print(f'read-back run: pytest exit {code_r}')
    return 1 if unread else 0


if __name__ == '__main__':
    sys.exit(main())
