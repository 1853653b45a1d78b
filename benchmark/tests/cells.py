"""The cells the tests drive, by name: those of ``BENCHMARK.json``, and the held ones,
whose configuration and traffic files stay for a later change to bring back
(``PERF.md``, Open questions)."""
from benchmark.harness import spec

BENCH = spec.load_spec()
HELD = {'lowfs_example.loop': ('lowfs_example', 'loop'),
        'broadband1024.step4': ('broadband1024', 'step4'),
        'wfc1024.sense': ('wfc1024', 'sense')}
CELLS = {**{w['name']: (w['config'], w['traffic']) for w in BENCH['workloads']}, **HELD}
