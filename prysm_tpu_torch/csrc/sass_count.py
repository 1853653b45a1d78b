"""Count the SASS instructions of each kernel in a ``cuobjdump -sass`` listing.

    cuobjdump -sass prysm_tpu_torch/_build/libzernike-*.so > new.sass
    python3 prysm_tpu_torch/csrc/sass_count.py new.sass [old.sass]

For each kernel function it prints the instruction count and the fp32
operations (an FFMA as two; FMUL, FADD, FMNMX as one) over the whole
function, not along a path; with a second listing, the same for the
function of that name there (its parameter list aside, so that a kernel
whose signature changed is still matched) and the opcodes whose counts
differ.
"""
import re
import sys
from collections import Counter

_FP32 = {'FFMA': 2, 'FMUL': 1, 'FADD': 1, 'FMNMX': 1}


def opcodes(path):
    """{function name without its parameter list: Counter of opcodes, the modifiers and
    the predicate dropped}."""
    out, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.match(r'\s+Function : (\S+)', line)
            if m:
                # a mangled template's name ends its arguments with EEEv, then
                # the parameter list
                name = m.group(1).split('EEEv')[0]
                out[name] = Counter()
                continue
            m = re.match(r'\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)', line)
            if name and m:
                out[name][m.group(1)] += 1
    return out


def summary(ops):
    return f'{sum(ops.values())} instructions, {sum(n * ops[k] for k, n in _FP32.items())} fp32 ops'


def main(new, old=None):
    new_ops, old_ops = opcodes(new), opcodes(old) if old else {}
    for name, ops in sorted(new_ops.items()):
        print(f'{name}: {summary(ops)}')
        if name in old_ops:
            was = old_ops[name]
            diff = {k: ops[k] - was[k] for k in sorted(set(ops) | set(was)) if ops[k] != was[k]}
            print(f'  was {summary(was)}; differs in {diff or "nothing"}')


if __name__ == '__main__':
    main(*sys.argv[1:3])
