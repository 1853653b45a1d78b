"""The broadband phase-retrieval step sharded over wavelengths, through
``prysm_tpu_torch.parallel.shard_broadband_step``.

Entry ``step``: back-to-back sharded steps, each the loss and gradient
(replicated on every rank), then a fixed-size step of the coefficients
against the gradient on every rank alike, on the card.  The ranks agree on
the window's step count before it opens (collectives pair up call by
call), from the slowest rank's pace over a few steps.  The measured image is
the benchmark's: the plain reference's float64 image of the seeded truth,
rounded to float32, handed to the program and to the judge alike.
"""
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from benchmark.harness import traffic as gen
from benchmark.harness.cell import Cell
from benchmark.reference.broadband1024 import BroadbandReference


#: the harness runs this configuration's cells as one process a rank, and hands the
#: judge every rank's answers
DISTRIBUTED = True


class Engine(NamedTuple):
    """coefs -> (loss, gradient), replicated."""
    step: Callable


def ranks(cfg):
    """The mesh's rank count."""
    return math.prod(cfg['mesh'].values())


def wavelengths(cfg):
    """The problem's wavelengths, um: wvl_per_chip a rank of the mesh, evenly over the band."""
    return np.linspace(cfg['wvl_min'], cfg['wvl_max'], cfg['wvl_per_chip'] * ranks(cfg))


def state(cfg, seed):
    """(truth, start) coefficients, nm, float64: each a seeded direction at a fixed
    length (``coef_rms_nm`` and ``start_offset_rms_nm`` a mode), so that every seed
    poses a problem of the same size and the judge's relative errors read alike."""
    g = gen.rng(seed, gen.STATE)
    K = len(cfg['modes'])

    def draw(rms):
        v = g.standard_normal(K)
        return v * (rms * np.sqrt(K) / np.linalg.norm(v))
    truth = draw(cfg['coef_rms_nm'])
    return truth, truth + draw(cfg['start_offset_rms_nm'])


def measured(cfg, wl, truth, device):
    """The measured image: the reference's float64 image of the truth, as float32."""
    with torch.no_grad():
        ref = BroadbandReference(cfg, wl, 'f64', device)
        return ref.image(torch.as_tensor(truth, device=device)).float()


def program(cfg, wl, I_meas, device):
    """The port's sharded step over a ``cfg['mesh']`` mesh of the process group."""
    from prysm_tpu_torch.coordinates import cart_to_polar, make_xy_grid
    from prysm_tpu_torch.geometry import antialias, circle_sdf
    from prysm_tpu_torch.parallel import make_mesh, plan_mdft_spectral, shard_broadband_step
    from prysm_tpu_torch.polynomials import zernike_nm_seq
    N = cfg['N']
    dx = cfg['diameter'] / N
    x, y = make_xy_grid(N, diameter=cfg['diameter'], device=device)
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    modes = zernike_nm_seq([tuple(m) for m in cfg['modes']], r, t)
    wl_t = torch.as_tensor(wl, dtype=amp.dtype, device=device)
    weights = torch.full((len(wl),), 1.0 / len(wl), dtype=amp.dtype, device=device)
    plan = plan_mdft_spectral(dx, (N, N), cfg['focal_dx'], cfg['fN'], wl, cfg['efl'],
                              device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != ranks(cfg):
        raise ValueError(f'the mesh {cfg["mesh"]} wants {ranks(cfg)} ranks; {world} run')
    mesh = make_mesh(dict(cfg['mesh']))
    return Engine(step=shard_broadband_step(mesh, plan, amp, modes, wl_t, weights, I_meas))


def control(cfg, seed, device, prec='tf32'):
    """The plain reference in the program's place, at a lower precision: one process
    computes every wavelength."""
    wl = wavelengths(cfg)
    I_meas = measured(cfg, wl, state(cfg, seed)[0], device)
    ref = BroadbandReference(cfg, wl, prec, device)
    return Engine(step=lambda c: ref.step(c, I_meas))


class BroadbandStep(Cell):
    """Back-to-back sharded steps; ``call(k)`` is step k."""

    def __init__(self, engine, cfg, traffic, seed, device):
        super().__init__(device)
        self.engine = engine
        self.c0 = state(cfg, seed)[1]
        self.size = traffic['coef_step_nm']
        self.pace_calls = traffic['pace_calls']
        self.every, self.offset = traffic['keep_every'], gen.keep_offset(seed, traffic['keep_every'])
        self.reset()

    def reset(self):
        self.c = torch.as_tensor(self.c0, dtype=torch.float32, device=self.device)
        self.kept = {}

    def call(self, k):
        loss, grad = self.engine.step(self.c)
        if k % self.every == self.offset:
            self.kept[k] = (self.c, loss, grad)
        self.c = self.c - self.size * grad / torch.sqrt(torch.mean(grad * grad))

    def plan_window(self, seconds):
        """Fix the window's step count from the slowest rank's pace."""
        self.finish()
        t0 = time.perf_counter()
        for k in range(self.pace_calls):
            self.call(k)
        self.finish()
        per = (time.perf_counter() - t0) / self.pace_calls
        self.reset()
        count = torch.tensor([math.ceil(seconds / per)], dtype=torch.int64,
                             device=self.device)
        if dist.is_initialized():
            dist.all_reduce(count, op=dist.ReduceOp.MIN)
        self.fixed_calls = int(count.item())

    def answers(self, calls):
        return {'kept': {k: tuple(v.cpu() for v in kv) for k, kv in self.kept.items()
                         if k < calls}}


def build(cfg, traffic, seed, device, engine=None):
    """The warmed cell of this configuration under ``traffic``."""
    if engine is None:
        wl = wavelengths(cfg)
        truth, _ = state(cfg, seed)
        engine = program(cfg, wl, measured(cfg, wl, truth, device), device)
    cell = BroadbandStep(engine, cfg, traffic, seed, device)
    cell.warm(traffic['warm_calls'])
    return cell


def judge(answers, cfg, traffic, seed, device):
    """The compared numbers of each step of a seeded sample of the kept ones: every
    rank's loss and gradient against one float64 computation of the whole problem,
    and the ranks' spread (coefficients, loss, gradient: replicated, so 0)."""
    wl = wavelengths(cfg)
    truth, _ = state(cfg, seed)
    I_meas = measured(cfg, wl, truth, device)
    ref = BroadbandReference(cfg, wl, 'f64', device)
    first = answers[0]['kept']
    out = []
    for k in gen.judge_sample(seed, first, traffic['judge_calls']):
        c0, loss0, grad0 = first[k]
        L, G = ref.step(c0.to(device).double(), I_meas)
        L = float(L)
        row = {'loss_err': 0.0, 'grad_err': 0.0, 'replica_diff': 0.0}
        for a in answers:
            c, loss, grad = a['kept'][k]
            row['replica_diff'] = max(
                row['replica_diff'], float(torch.max(torch.abs(c - c0))),
                abs(float(loss) - float(loss0)) / abs(float(loss0)),
                float(torch.max(torch.abs(grad - grad0)) / torch.max(torch.abs(grad0))))
            row['loss_err'] = max(row['loss_err'], abs(float(loss) - L) / abs(L))
            row['grad_err'] = max(row['grad_err'],
                                  float(torch.max(torch.abs(grad.to(device).double() - G))
                                        / torch.max(torch.abs(G))))
        out.append(row)
    return out
