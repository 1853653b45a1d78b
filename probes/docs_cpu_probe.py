"""The executed docs' float32 errors on the CPU: the JAX package's own and the port's.

Run from the repository root (no card needed; ~6 min):

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 probes/docs_cpu_probe.py [doc ...]

For every doc of ``prysm_tpu_torch.docs.EXECUTED`` it runs the JAX package's
doc (``docs/<doc>``) with x64 on and with x64 off, each in a process of its
own, and the port's (``docs/torch/<doc>``) on the CPU in float64 and in
float32.  The float32 runs take the float64 runs' random draws
(``jax.random.uniform`` / ``normal`` and ``torch.rand`` / ``randn``, as
``docs.REPLAYED`` says), so that they differ by rounding alone.  The JAX
deformable-mirror doc builds its influence function in float32 whatever
x64 says; its float64 results are recomputed from the same function in
float64.  It prints, for every result of ``docs.RESULTS``,
``max |f32 - f64| / max |f64|`` for the JAX package and for the port, and
last the JAX package's figures as the ``DOCS_JAX_F32`` table that phase 3s
of ``chip_smoke.py`` doubles into its float32 bars where they exceed the
tier of the result's kind.  A JAX doc whose float32 run fails a block has
no figure for the results after it.

These are CPU numbers: they say how float32 rounding propagates through each
doc, not what the card does.
"""
import multiprocessing
import os
import re
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCK = re.compile(r'```python\n(.*?)```', re.S)


def _dm_from_f64_ifn(ns):
    """The deformable-mirror doc's results from its influence function in float64: the
    JAX doc rounds it to float32, so its DM computes in float32 with x64 on too, and its
    float64 reference is this recomputation."""
    import jax
    import jax.numpy as jnp
    from prysm_tpu.x.dm import DM
    ifn = np.exp(-(ns['X'] ** 2 + ns['Y'] ** 2) / (2 * ns['sigma'] ** 2))
    render = jax.jit(DM(ifn, Nout=64, Nact=9, sep=ns['pitch']).render_fn(wfe=True))
    acts = jnp.zeros((9, 9)).at[4, 4].set(1.0)
    target = render(acts) * 0.5

    def loss(a):
        return jnp.sum((render(a) - target) ** 2)

    a = acts
    for _ in range(20):
        a = a - 1e-3 * jax.grad(loss)(a)
    return {'sfe': np.asarray(render(acts), np.float64),
            'g': np.asarray(jax.grad(loss)(acts), np.float64), 'a': np.asarray(a, np.float64)}


def _jax_docs(x64, names, draws):
    """{doc: ({result: value}, error or None)} and {doc: draws} of the JAX docs."""
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', x64)
    sys.path.insert(0, ROOT)
    from prysm_tpu_torch import docs
    originals = {'rand': jax.random.uniform, 'randn': jax.random.normal}
    out, recorded = {}, {}

    def drawing(kind, doc):
        def drawn(key, shape=(), dtype=None, *args, **kwargs):
            if draws is not None:
                a = draws[doc][kind].pop(0)
                return jax.numpy.asarray(a, dtype=dtype or jax.numpy.result_type(float))
            value = originals[kind](key, shape, dtype, *args, **kwargs) if dtype else \
                originals[kind](key, shape, *args, **kwargs)
            recorded[doc][kind].append(np.asarray(value, np.float64))
            return value
        return drawn

    for doc in names:
        code = _BLOCK.findall(open(os.path.join(ROOT, 'docs', doc)).read())
        limit = docs.EXECUTED[doc]
        code = code[:limit] if limit is not None else code
        recorded[doc] = {'rand': [], 'randn': []}
        jax.random.uniform, jax.random.normal = drawing('rand', doc), drawing('randn', doc)
        ns, error = {}, None
        with tempfile.TemporaryDirectory() as tmp:
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                for k, block in enumerate(code):
                    exec(compile(block, f'{doc}[block {k}]', 'exec'), ns)
            except Exception as e:
                error = f'block {k}: {type(e).__name__}: {str(e)[:120]}'
            finally:
                os.chdir(cwd)
                jax.random.uniform, jax.random.normal = originals['rand'], originals['randn']
        values = {}
        for name in docs.RESULTS[doc]:
            try:
                values[name] = docs.value(ns, name)
            except Exception:
                pass
        if x64 and doc == 'explanation/deformable-mirrors.md' and error is None:
            values.update(_dm_from_f64_ifn(ns))
        out[doc] = (values, error)
    return out, recorded


def _port_docs(dtype_name, names, draws):
    """{doc: ({result: value}, error or None)} and {doc: draws} of the port's docs."""
    sys.path.insert(0, ROOT)
    import torch
    from prysm_tpu_torch import docs
    from prysm_tpu_torch.conf import config
    torch.set_num_threads(4)
    config.device = 'cpu'
    config.precision = getattr(torch, dtype_name)
    out, recorded = {}, {}
    with tempfile.TemporaryDirectory() as tmp, docs.in_directory(tmp):
        for doc in names:
            replay = draws is not None and doc in docs.REPLAYED
            record = docs.Draws(draws[doc] if replay else None)
            try:
                ns, error = docs.run(doc, draws=record), None
            except Exception as e:
                ns, error = {}, str(e).splitlines()[0][:160]
            recorded[doc] = record.recorded
            values = {}
            for name in docs.RESULTS[doc]:
                try:
                    values[name] = docs.value(ns, name)
                except Exception:
                    pass
            out[doc] = (values, error)
    return out, recorded


def _errors(f32, f64):
    from prysm_tpu_torch.docs import relative_error
    errors = {}
    for doc, (values, error) in f32.items():
        for name, v in values.items():
            try:
                errors[doc, name] = relative_error(v, f64[doc][0][name])
            except (KeyError, ValueError) as e:
                errors[doc, name] = f'n/a ({e})'
        if error:
            errors[doc, '(failed)'] = error
    return errors


def main(argv):
    sys.path.insert(0, ROOT)
    from prysm_tpu_torch import docs
    names = argv or sorted(docs.EXECUTED)
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(2) as pool:
        jax64 = pool.apply_async(_jax_docs, (True, names, None))
        port64 = pool.apply_async(_port_docs, ('float64', names, None))
        (j64, jdraws), (p64, pdraws) = jax64.get(), port64.get()
        jax32 = pool.apply_async(_jax_docs, (False, names, jdraws))
        port32 = pool.apply_async(_port_docs, ('float32', names, pdraws))
        (j32, _), (p32, _) = jax32.get(), port32.get()
    jerr, perr = _errors(j32, j64), _errors(p32, p64)
    print(f'{"doc":52s} {"result":16s} {"JAX f32":>12s} {"port f32 (CPU)":>15s}')
    for key in sorted(set(jerr) | set(perr)):
        je, pe = jerr.get(key, '-'), perr.get(key, '-')
        fmt = lambda v: f'{v:12.3g}' if isinstance(v, float) else f'{str(v)[:60]:>12s}'
        print(f'{key[0]:52s} {key[1]:16s} {fmt(je)} {fmt(pe)}')
    table = {f'{doc}::{name}': float(f'{e:.3g}') for (doc, name), e in sorted(jerr.items())
             if isinstance(e, float)}
    print('DOCS_JAX_F32 =', table)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
