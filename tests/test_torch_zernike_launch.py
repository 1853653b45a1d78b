"""The host side of a Zernike kernel launch (``prysm_tpu_torch.ops.zernike``), without a card.

The kernels in ``csrc/zernike.cu`` run only on the card; what the host
hands them is tested here: the walk program a plan compiles to
(``_program``) and its pieces (``_chunks``), replayed in plain PyTorch
with the kernel's rules and held against the plain versions (the forward
and coefficient walk, and the full backward's per-group fold of the chain
rule); the compiled program size it selects; the pieces packed as the
kernels' by-value ``Params<KMAX>``; and the pixel partition (``_span``,
``_vec_bits``), replayed in plain Python with the kernel's rule for which
thread takes which pixels.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from prysm_tpu_torch.ops import zernike as zk
from prysm_tpu_torch.steps import NMS6

NMS45 = tuple((n, m) for n in range(9) for m in range(-n, n + 1, 2))
TURN, RESET, STEP = zk._TURN, zk._RESET, zk._STEP
# the program sizes the library exports (csrc/zernike.cu PRYSM_ZERNIKE_BUCKETS)
_SRC = (Path(zk.__file__).parent.parent / 'csrc' / 'zernike.cu').read_text()
BUCKETS = tuple(int(k) for k in re.findall(
    r'X\((\d+)\)', re.search(r'#define PRYSM_ZERNIKE_BUCKETS\(X\) (.*)', _SRC).group(1)))


def _full(nmax):
    return tuple((n, m) for n in range(nmax + 1) for m in range(-n, n + 1, 2))


def test_compiled_program_sizes():
    assert BUCKETS == (4, 32)


@pytest.mark.parametrize('nms, slots, bucket', [
    (NMS6, 4, 4), (_full(5), 12, 32), (NMS45, 25, 32),
    (tuple((n, 0) for n in range(0, 24, 2)), 12, 32), (((40, 0),), 20, 32)],
    ids=['nms6', 'n5', 'nms45', 'radial12', 'deep'])
def test_plan_selects_smallest_bucket(nms, slots, bucket):
    prog = zk._program(zk._plan(nms, True))
    assert len(prog) == slots
    kmax = zk._bucket(len(prog), BUCKETS)
    assert kmax == bucket
    # a program that fits runs in one launch, with an empty prologue
    assert zk._chunks(prog, kmax) == (zk._Piece(0, (), prog),)
    blobs, rows = zk._params(zk._plan(nms, True), kmax)
    assert len(blobs) == 1 and rows.shape == (0, 3)


RADIAL34 = tuple((n, 0) for n in range(0, 68, 2))


@pytest.mark.parametrize('nms, slots, pieces', [
    (_full(10), 36, 2), (_full(11), 42, 2), (RADIAL34, 34, 2), (((200, 0),), 100, 1),
    (((66, 0), (3, -1)), 34, 1), (((40, 40), (1, 1)), 40, 2)],
    ids=['n10', 'n11', 'radial34', 'deep200', 'deep66', 'm40'])
def test_long_program_runs_in_pieces(nms, slots, pieces):
    prog = zk._program(zk._plan(nms, True))
    assert len(prog) == slots
    kmax = zk._bucket(len(prog), BUCKETS)
    assert kmax == BUCKETS[-1]
    chunks = zk._chunks(prog, kmax)
    assert len(chunks) == pieces
    assert all(1 <= len(p.slots) <= kmax for p in chunks)
    # every mode is used in exactly one piece
    used = sorted(idx for p in chunks for _, _, c, s, _ in p.slots
                  for idx, _ in (c, s) if idx >= 0)
    assert used == list(range(len(nms)))
    # a piece starts with a slot that uses a mode: the walk before it is its prologue
    assert all(zk._uses(p.slots[0]) for p in chunks[1:])


def test_pieces_cut_at_group_starts():
    # the 66 modes to n = 10: the first piece ends before the group that would
    # overflow it; the second turns the angle to that group's |m| - 1 first
    prog = zk._program(zk._plan(_full(10), True))
    first, second = zk._chunks(prog, 32)
    assert second.slots[0][0] & (TURN | RESET) and second.rows == ()
    assert second.turns == first.slots[-1][1] == second.slots[0][1] - 1
    assert first.slots + second.slots == prog
    # one group of 34 slots: cut after 32, the second piece steps through the
    # recurrence rows of the first (the first slot resets and takes no step)
    prog = zk._program(zk._plan(RADIAL34, True))
    first, second = zk._chunks(prog, 32)
    assert len(first.slots) == 32 and second.turns == 0
    assert second.rows == tuple(s[4] for s in prog[:32] if s[0] & STEP)
    assert len(second.rows) == 31
    # a lone deep mode: the slots before it only walk, so they all go into
    # the prologue of a single piece
    prog = zk._program(zk._plan(((200, 0),), True))
    (only,) = zk._chunks(prog, 32)
    assert only.slots == prog[-1:] and len(only.rows) == 99
    # a jump of |m| from 1 to 40: the first piece drops the turns that use
    # nothing, and the second makes them in its prologue
    prog = zk._program(zk._plan(((40, 40), (1, 1)), True))
    first, second = zk._chunks(prog, 32)
    assert first.slots == prog[:1] and second.slots == prog[-1:] and second.turns == 39


def test_program_of_nms6():
    plan = zk._plan(NMS6, True)
    prog = zk._program(plan)
    # |m| = 0: (2, 0) after one step, (4, 0) after another; |m| = 1: a turn,
    # one step, then (3, 1) and (3, -1) together; |m| = 2: a turn, no step,
    # (2, 2) and (2, -2) together
    assert [(op, am, c[0], s[0]) for op, am, c, s, _ in prog] == [
        (RESET | STEP, 0, 0, -1), (STEP, 0, 5, -1),
        (TURN | RESET | STEP, 1, 3, 4), (TURN | RESET, 2, 1, 2)]
    rows = [row for *_, row in prog]
    assert rows[:3] == [plan.abc[0], plan.abc[1], plan.abc[2]]
    assert rows[3] == zk._NO_STEP == (0.0, 1.0, 0.0)
    weights = {idx: w for (idx, _, _), w in zip(plan.modes, plan.weights)}
    for *_, c, s, _ in prog:
        for idx, w in (c, s):
            assert w == (weights[idx] if idx >= 0 else 0.0)


def test_program_adds_walk_only_slots():
    # |m| jumps 0 -> 3: two slots that only turn the angle; a sin mode listed
    # before its cos mode still shares the slot
    prog = zk._program(zk._plan(((5, -3), (0, 0), (5, 3)), False))
    assert [(op, am, c[0], s[0]) for op, am, c, s, _ in prog] == [
        (RESET, 0, 1, -1), (TURN, 1, -1, -1), (TURN, 2, -1, -1),
        (TURN | RESET | STEP, 3, 2, 0)]
    # a lone high radial order: one step per slot, the mode in the last
    deep = zk._program(zk._plan(((8, 0),), False))
    assert [op for op, *_ in deep] == [RESET | STEP, STEP, STEP, STEP]
    assert [c[0] for _, _, c, _, _ in deep] == [-1, -1, -1, 0]


def _replay(pieces, coefs, r, t, g):
    """csrc/zernike.cu's walk, piece by piece, in plain PyTorch: (OPD, coefficient cotangent)."""
    x, c1, s1 = 2 * r * r - 1, torch.cos(t), torch.sin(t)
    opd = torch.zeros_like(r)
    cg = torch.zeros(len(coefs), dtype=r.dtype)
    for turns, rows, slots in pieces:
        # the prologue: the turns, a reset, the steps of the group in progress
        ca, sa, ram = torch.ones_like(r), torch.zeros_like(r), torch.ones_like(r)
        for _ in range(turns):
            ca, sa, ram = ca * c1 - sa * s1, sa * c1 + ca * s1, ram * r
        P, Pp, uc, us = torch.ones_like(r), torch.zeros_like(r), ram * ca, ram * sa
        for A, B, C in rows:
            P, Pp = (A * x + B) * P - C * Pp, P
        for op, _, cos, sin, (A, B, C) in slots:
            if op & TURN:
                ca, sa, ram = ca * c1 - sa * s1, sa * c1 + ca * s1, ram * r
            if op & RESET:
                P, Pp, uc, us = torch.ones_like(r), torch.zeros_like(r), ram * ca, ram * sa
            # a slot without a step has (A, B, C) = (0, 1, 0): P stays, and so does Pp
            Pn = (A * x + B) * P - C * Pp
            Pp = P if op & STEP else Pp
            P = Pn
            for (idx, w), u in ((cos, uc), (sin, us)):
                Z = P * u
                if idx >= 0:
                    opd = opd + coefs[idx] * w * Z
                    cg[idx] = torch.sum(g * Z) * w
    return opd, cg


def _replay_case(nms, norm):
    rng = np.random.default_rng(21)
    x, y = np.meshgrid(np.linspace(-1.1, 1.1, 19), np.linspace(-1.05, 1.1, 17))
    r, t = torch.from_numpy(np.hypot(x, y)), torch.from_numpy(np.arctan2(y, x))
    g = torch.from_numpy(rng.standard_normal(r.shape))
    coefs = torch.from_numpy(rng.standard_normal(len(nms)))
    plan = zk._plan(tuple(nms), norm)
    return plan, coefs, r, t, g


def _assert_replay(pieces, plan, coefs, r, t, g):
    opd, cg = _replay(pieces, coefs, r, t, g)
    want_opd = zk.zernike_fwd_plain(plan, coefs, r, t)
    want_cg = zk.zernike_bwd_coefs_plain(plan, r, t, g)
    assert float((opd - want_opd).abs().max() / want_opd.abs().max()) < 1e-12
    assert float((cg - want_cg).abs().max() / want_cg.abs().max()) < 1e-12


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('nms', [NMS6, NMS45, ((5, -3), (0, 0), (5, 3)), ((8, 0), (3, -1)),
                                 ((4, -2), (2, 0), (4, 2), (6, -2))],
                         ids=['nms6', 'nms45', 'gap', 'deep', 'unordered'])
def test_program_replay_matches_plain_versions(nms, norm):
    plan, coefs, r, t, g = _replay_case(nms, norm)
    _assert_replay((zk._Piece(0, (), zk._program(plan)),), plan, coefs, r, t, g)


@pytest.mark.parametrize('kmax', [1, 3, 4, 32])
@pytest.mark.parametrize('nms', [NMS45, _full(10), RADIAL34[:20], ((5, -3), (0, 0), (5, 3)),
                                 ((8, 0), (3, -1)), ((9, 9), (12, 0), (7, -5))],
                         ids=['nms45', 'n10', 'radial20', 'gap', 'deep', 'jumps'])
def test_pieces_replay_matches_plain_versions(nms, kmax):
    # small program sizes cut the same plans mid-group, across |m| jumps and often
    plan, coefs, r, t, g = _replay_case(nms, True)
    pieces = zk._chunks(zk._program(plan), kmax)
    assert all(len(p.slots) <= kmax for p in pieces)
    _assert_replay(pieces, plan, coefs, r, t, g)


def _replay_all(pieces, coefs, r, t, g):
    """csrc/zernike.cu's kAll walk, piece by piece, in plain PyTorch: (cg, gr, gt).

    Each slot adds c w P and c w D of its cos and sin modes into its |m|
    group's four sums and g r^|m| cos(|m| t) P (or sin) into its modes'
    <Z, g> sums; the group's sums fold into the r and t cotangents at the
    next group start and at the end of the piece; g multiplies the
    cotangents once, at the end, and a later piece adds to the earlier ones.
    """
    x, c1, s1 = 2 * r * r - 1, torch.cos(t), torch.sin(t)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    cg = torch.zeros(len(coefs), dtype=r.dtype)
    out_r, out_t = zero, zero
    for turns, rows, slots in pieces:
        w = dict(ca=one, sa=zero, ram=one, ram_m1=one)
        sums = dict(Pc=zero, Ps=zero, Dc=zero, Ds=zero)
        gr, gt = zero, zero

        def turn():
            w.update(ca=w['ca'] * c1 - w['sa'] * s1, sa=w['sa'] * c1 + w['ca'] * s1,
                     ram=w['ram'] * r, ram_m1=w['ram'])

        def restart():
            gram = g * w['ram']
            w.update(P=one, Pp=zero, D=zero, Dp=zero, guc=gram * w['ca'], gus=gram * w['sa'])

        def advance(A, B, C, step):
            lin = A * x + B
            P, D = lin * w['P'] - C * w['Pp'], A * w['P'] + lin * w['D'] - C * w['Dp']
            if step:
                w.update(Pp=w['P'], Dp=w['D'])
            w.update(P=P, D=D)

        def fold(am):
            """The group's d/dr and d/dt of sum c w Z, before g; its sums cleared."""
            du, q = am * w['ram_m1'], (r * w['ram']) * 4
            ac = sums['Pc'] * du + sums['Dc'] * q
            as_ = sums['Ps'] * du + sums['Ds'] * q
            dt = (am * w['ram']) * (sums['Ps'] * w['ca'] - sums['Pc'] * w['sa'])
            sums.update(Pc=zero, Ps=zero, Dc=zero, Ds=zero)
            return ac * w['ca'] + as_ * w['sa'], dt

        for _ in range(turns):
            turn()
        restart()
        for A, B, C in rows:
            advance(A, B, C, True)
        am = turns
        for j, (op, slot_am, cos, sin, (A, B, C)) in enumerate(slots):
            if op & (TURN | RESET):
                if j > 0:
                    dr, dt = fold(am)
                    gr, gt = gr + dr, gt + dt
                if op & TURN:
                    turn()
                if op & RESET:
                    restart()
                am = slot_am
            advance(A, B, C, op & STEP)
            for (idx, wt), side, gu in ((cos, 'c', w['guc']), (sin, 's', w['gus'])):
                cw = coefs[idx] * wt if idx >= 0 else 0.0
                sums['P' + side] = sums['P' + side] + cw * w['P']
                sums['D' + side] = sums['D' + side] + cw * w['D']
                if idx >= 0:
                    cg[idx] = torch.sum(gu * w['P']) * wt
        dr, dt = fold(am)
        out_r, out_t = out_r + g * (gr + dr), out_t + g * (gt + dt)
    return cg, out_r, out_t


def _rel_or_zero(got, want):
    """max |got - want| / max |want|; where want is all zero, max |got|."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


@pytest.mark.parametrize('kmax', [None, 32, 3], ids=['one_piece', 'cut32', 'cut3'])
@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('nms', [NMS6, NMS45, _full(10), RADIAL34],
                         ids=['nms6', 'nms45', 'nms66', 'radial34'])
def test_all_fold_replay_matches_plain_version(nms, norm, kmax):
    """The kAll kernel's per-group fold, rehearsed in f64, is the plain full VJP."""
    plan, coefs, r, t, g = _replay_case(nms, norm)
    prog = zk._program(plan)
    pieces = (zk._Piece(0, (), prog),) if kmax is None else zk._chunks(prog, kmax)
    got = _replay_all(pieces, coefs, r, t, g)
    want = zk.zernike_bwd_all_plain(plan, coefs, r, t, g)
    for a, b in zip(got, want):
        assert _rel_or_zero(a, b) < 1e-12
    if all(am == 0 for am, *_ in plan.groups):
        assert not got[2].any() and not want[2].any()


_HEAD = 5  # int32 K, turns, pre, pre_at, add


def _unpack(blob, kmax):
    ints = np.frombuffer(blob, '<i4', count=_HEAD + 4 * kmax)
    floats = np.frombuffer(blob, '<f4', offset=4 * (_HEAD + 4 * kmax))
    return (ints[:_HEAD].tolist(), ints[_HEAD:_HEAD + kmax], ints[_HEAD + kmax:_HEAD + 2 * kmax],
            ints[_HEAD + 2 * kmax:].reshape(kmax, 2), floats[:2 * kmax].reshape(kmax, 2),
            floats[2 * kmax:].reshape(kmax, 3))


def test_params_layout_and_size():
    plan = zk._plan(NMS6, True)
    (blob,), rows = zk._params(plan, 4)
    # int32 K, turns, pre, pre_at, add; int32 op and |m| per slot; int32
    # (cos, sin) index per slot; float32 (cos, sin) w per slot; float32
    # (A, B, C) per slot
    assert len(blob) == 4 * (5 + 2 * 4 + 2 * 4 + 2 * 4 + 3 * 4) == 164
    head, op, am, idx, w, abc = _unpack(blob, 4)
    prog = zk._program(plan)
    assert head == [4, 0, 0, 0, 0] and rows.shape == (0, 3)
    assert op.tolist() == [s[0] for s in prog] and am.tolist() == [s[1] for s in prog]
    assert idx.tolist() == [[s[2][0], s[3][0]] for s in prog]
    assert np.array_equal(w, np.float32([[s[2][1], s[3][1]] for s in prog]))
    assert np.array_equal(abc, np.float32([s[4] for s in prog]))


def test_params_pad_to_the_bucket():
    (blob,), _ = zk._params(zk._plan(((5, -3), (0, 0)), True), 4)
    assert _unpack(blob, 4)[0][0] == 4  # fills the smallest size exactly
    (blob,), _ = zk._params(zk._plan(_full(5), False), 32)  # 12 slots of 32
    head, op, am, idx, w, abc = _unpack(blob, 32)
    K = head[0]
    assert K == 12 and len(blob) == 4 * 5 + 36 * 32 == 1172
    # slots past K are never run; they are packed as no-ops
    assert not op[K:].any() and not am[K:].any() and (idx[K:] == -1).all()
    assert not w[K:].any() and (abc[K:] == np.float32(zk._NO_STEP)).all()
    assert len(zk._params(zk._plan(NMS45, True), 32)[0][0]) == 1172


@pytest.mark.parametrize('nms', [_full(10), RADIAL34, ((200, 0),)], ids=['n10', 'radial34',
                                                                          'deep200'])
def test_params_of_pieces(nms):
    plan = zk._plan(nms, True)
    pieces = zk._chunks(zk._program(plan), 32)
    blobs, rows = zk._params(plan, 32)
    assert len(blobs) == len(pieces) and rows.dtype == np.float32
    at = 0
    for i, (blob, piece) in enumerate(zip(blobs, pieces)):
        (K, turns, pre, pre_at, add), op, *_ = _unpack(blob, 32)
        assert (K, turns, pre, pre_at, add) == (len(piece.slots), piece.turns, len(piece.rows),
                                                at, int(i > 0))
        assert op[:K].tolist() == [s[0] for s in piece.slots]
        # the piece's prologue rows, rounded to float32, at pre_at in the shared table
        assert np.array_equal(rows[pre_at:pre_at + pre], np.float32(piece.rows).reshape(-1, 3))
        at += pre
    assert len(rows) == at


def _thread_pixels(ptr, npix, threads):
    """Replay csrc/zernike.cu's loop: body quad q goes to thread q % threads; the
    head goes to thread 0 and the tail to thread 1."""
    head, quads, tail = zk._span(ptr, npix)
    owned = [[] for _ in range(threads)]
    for q in range(quads):
        i0 = head + 4 * q
        assert (ptr + 4 * i0) % 16 == 0  # a body quad is one 16-byte access
        owned[q % threads].extend(range(i0, i0 + 4))
    owned[0].extend(range(head))
    owned[1].extend(range(head + 4 * quads, npix))
    return (head, quads, tail), owned


@pytest.mark.parametrize('shape, offset', [((31, 31), 0), ((33, 17), 1), ((16, 16), 2),
                                           ((7, 9), 3), ((1, 1), 1), ((2, 1), 3)],
                         ids=['odd', 'odd_offset1', 'even_offset2', 'odd_offset3',
                              'one_pixel', 'short_head'])
@pytest.mark.parametrize('threads', [32, 256])
def test_partition_covers_each_pixel_once(shape, offset, threads):
    base = torch.zeros(shape[0] * shape[1] + offset)
    r = base[offset:].view(shape)  # a contiguous view with a storage offset
    assert r.storage_offset() == offset
    npix = r.numel()
    (head, quads, tail), owned = _thread_pixels(r.data_ptr(), npix, threads)
    assert head == min((-offset) % 4, npix) and 0 <= tail <= 3 and head + 4 * quads + tail == npix
    flat = sorted(p for pixels in owned for p in pixels)
    assert flat == list(range(npix))


def test_partition_of_an_odd_size_storage():
    # 1023^2 pixels from an aligned start: no head, one pixel in the tail
    assert zk._span(0x7f0000000000, 1023 ** 2) == (0, (1023 ** 2) // 4, 1)
    assert zk._span(0x7f0000000004, 1023 ** 2) == (3, (1023 ** 2 - 3) // 4, 2)


def test_vec_bits():
    head, _, _ = zk._span(0x1004, 100)
    assert head == 3
    # r, and a t at the same offset, are aligned at pixel 3; g four bytes later is not;
    # o0 (fresh, 16-byte aligned) is not aligned at pixel 3; o1 absent
    assert zk._vec_bits([0x1004, 0x2004, 0x3008, 0x4000, None], head) == 0b00011
    assert zk._vec_bits([0x1000, 0x2000, 0x3000, 0x4000, 0x5000], 0) == 0b11111
