"""Count the SASS instructions of each kernel in a ``cuobjdump -sass`` listing.

    cuobjdump -sass prysm_tpu_torch/_build/libzernike-*.so > new.sass
    python3 prysm_tpu_torch/csrc/sass_count.py new.sass [old.sass]
    python3 prysm_tpu_torch/csrc/sass_count.py new.sass --path NAME --skip 1f0-2a0,11b0,15b0

For each kernel function it prints the instruction count and, by the pipe
that issues them, the fp32 operations (an FFMA as two; FMUL, FADD, FMNMX,
FRND as one), the integer instructions of the ALU pipe (adds, logic,
shifts, compares) and the integer multiplies of the FMA pipe (IMAD, its
.WIDE and .HI forms, IMUL), over the whole function, not along a path.
Uniform-datapath instructions (run once per warp, not per thread) and
register moves (IMAD.MOV, an IMAD of RZ by RZ) are not counted; nor are
moves, selects, conversions, loads and branches.  With a second listing,
the same for the function of that name there (its parameter list aside, so
that a kernel whose signature changed is still matched) and the opcodes
whose counts differ.

With --path, it counts the one function whose name contains NAME along a
path: every instruction but those at the hexadecimal addresses and address
ranges given to --skip (the branches a path does not take, and any
instruction to leave out of a count, such as index and address
arithmetic), and prints the opcodes counted.
"""
import argparse
import re
from collections import Counter

_FP32 = {'FFMA': 2, 'FMUL': 1, 'FADD': 1, 'FMNMX': 1, 'FRND': 1}
_ALU = {'IADD3', 'LOP3', 'SHF', 'LEA', 'ISETP', 'IABS', 'IMNMX', 'VIADD', 'VIADDMNMX',
        'BMSK', 'SGXT', 'POPC', 'FLO', 'BREV', 'PRMT'}
_IMAD = {'IMAD', 'IMUL'}


def instructions(path):
    """{function name without its parameter list: [(address, opcode, operands), ...]}, each
    opcode with its modifiers and without its predicate."""
    out, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.match(r'\s+Function : (\S+)', line)
            if m:
                # a mangled template's name ends its arguments with EEEv, then
                # the parameter list
                name = m.group(1).split('EEEv')[0]
                out[name] = []
                continue
            m = re.match(r'\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*)',
                         line)
            if name and m:
                out[name].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def counted(opcode, operands):
    """(pipe, weight) of one instruction: 'fp32', 'alu' or 'imad', or (None, 0)."""
    base = opcode.split('.')[0]
    if base in _FP32:
        return 'fp32', _FP32[base]
    if base in _ALU:
        return 'alu', 1
    moves = opcode.startswith('IMAD.MOV') or operands.split(', ')[1:3] == ['RZ', 'RZ']
    if base in _IMAD and not moves:
        return 'imad', 1
    return None, 0


def summary(listing):
    pipes = Counter()
    for _, opcode, operands in listing:
        pipe, weight = counted(opcode, operands)
        if pipe:
            pipes[pipe] += weight
    return (f'{len(listing)} instructions, {pipes["fp32"]} fp32 ops, {pipes["alu"]} int32 ALU '
            f'and {pipes["imad"]} IMAD instructions')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('new')
    ap.add_argument('old', nargs='?')
    ap.add_argument('--path', help='count only the function whose name contains this')
    ap.add_argument('--skip', default='',
                    help='hex addresses and address ranges a,b-c left off the path')
    args = ap.parse_args()
    new = instructions(args.new)
    if args.path:
        (name,) = [n for n in new if args.path in n]
        skip = [tuple(int(x, 16) for x in (r.split('-') * 2)[:2])
                for r in args.skip.split(',') if r]
        listing = [ins for ins in new[name] if not any(a <= ins[0] <= b for a, b in skip)]
        print(f'{name} along the path: {summary(listing)}')
        for pipe in ('fp32', 'alu', 'imad'):
            ops = Counter(opcode for _, opcode, operands in listing
                          if counted(opcode, operands)[0] == pipe)
            print(f'  {pipe}: ' + ', '.join(f'{k} {n}' for k, n in ops.most_common()))
        return
    old = instructions(args.old) if args.old else {}
    for name, listing in sorted(new.items()):
        print(f'{name}: {summary(listing)}')
        if name in old:
            ops = Counter(opcode for _, opcode, _ in listing)
            was = Counter(opcode for _, opcode, _ in old[name])
            diff = {k: ops[k] - was[k] for k in sorted(set(ops) | set(was)) if ops[k] != was[k]}
            print(f'  was {summary(old[name])}; differs in {diff or "nothing"}')


if __name__ == '__main__':
    main()
