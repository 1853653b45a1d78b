"""The LOWFS closed loop, through ``prysm_tpu_torch.examples.lowfs_realtime``.

Entry ``loop``: each frame uploads the 6-float command, renders the camera
frame at the command plus the seeded drift (``render``), estimates the 6
coefficients (``sense``: one matvec) and reads them to the host, where an
integrator with a fixed gain forms the next command.  Each frame's latency
is the card's time from the upload to the estimates' arrival (CUDA events
on the stream around the frame).
"""
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from benchmark.harness import traffic as gen
from benchmark.harness.cell import Cell
from benchmark.reference.common import peak_error
from benchmark.reference.lowfs_example import LowfsReference


class Engine(NamedTuple):
    """The two calls a frame makes: coefficients -> frame -> estimates."""
    frame: Callable
    estimate: Callable


def program(cfg, device):
    """The port's sensor: its set-up, reconstructor (jacfwd + pinv), render and sense."""
    from prysm_tpu_torch.examples import lowfs_realtime as lr
    if [list(nm) for nm in lr.NMS] != cfg['modes'] or lr.DEFOCUS_BIAS_NM != cfg['defocus_bias_nm']:
        raise ValueError('the example no longer runs this configuration (modes or bias)')
    setup = lr.build(N=cfg['N'], fN=cfg['fN'], wvl=cfg['wvl'], efl=cfg['efl'], device=device)
    R, I0 = lr.reconstructor(setup)
    return Engine(frame=lambda c: lr.render(c, **setup), estimate=lambda f: lr.sense(f, R, I0))


def control(cfg, seed, device, prec='tf32'):
    """The plain reference in the program's place, at a lower precision."""
    ref = LowfsReference(cfg, prec, device)
    return Engine(frame=ref.frame, estimate=ref.estimate)


class LowfsLoop(Cell):
    """The closed loop; ``call(k)`` is frame k."""

    def __init__(self, engine, cfg, traffic, seed, device):
        super().__init__(device)
        self.engine = engine
        self.K = len(cfg['modes'])
        self.gain = traffic['gain']
        self.drift = gen.drift(seed, gen.DRIFT, traffic['table_frames'], self.K,
                               traffic['drift_rms_nm'], traffic['drift_corr_frames'],
                               traffic['drift_bound_nm'])
        cuda = self.device.type == 'cuda'
        self.c_pin = torch.zeros(self.K, dtype=torch.float32, pin_memory=cuda)
        self.e_pin = torch.zeros(self.K, dtype=torch.float32, pin_memory=cuda)
        self.c_host, self.e_host = self.c_pin.numpy(), self.e_pin.numpy()
        self.c_dev = torch.zeros(self.K, dtype=torch.float32, device=self.device)
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) if cuda else None
        cap = traffic['max_frames']
        self.inputs = np.zeros((cap, self.K), np.float32)
        self.estimates = np.zeros((cap, self.K), np.float32)
        self.latency_ms = np.zeros(cap)
        self.every, self.offset = traffic['keep_every'], gen.keep_offset(seed, traffic['keep_every'])
        self.reset()

    def reset(self):
        self.u = np.zeros(self.K)
        self.kept = {}

    def call(self, k):
        self.c_host[:] = self.u + self.drift[k % len(self.drift)]
        if self.events is None:  # the CPU tests: the host's clock
            t0 = time.perf_counter()
        else:
            self.events[0].record()
        self.c_dev.copy_(self.c_pin, non_blocking=True)
        frame = self.engine.frame(self.c_dev)
        self.e_pin.copy_(self.engine.estimate(frame), non_blocking=True)
        if self.events is None:
            lat = (time.perf_counter() - t0) * 1e3
        else:
            self.events[1].record()
            self.events[1].synchronize()
            lat = self.events[0].elapsed_time(self.events[1])
        if k < len(self.inputs):
            self.inputs[k], self.estimates[k], self.latency_ms[k] = self.c_host, self.e_host, lat
            if k % self.every == self.offset:
                self.kept[k] = frame
        self.u -= self.gain * self.e_host

    def latencies(self, calls):
        """Each frame's latency, ms, of the first ``calls`` frames."""
        return self.latency_ms[:min(calls, len(self.latency_ms))]

    def answers(self, calls):
        n = min(calls, len(self.inputs))
        return {'inputs': self.inputs[:n].copy(), 'estimates': self.estimates[:n].copy(),
                'frames': {k: f.cpu() for k, f in self.kept.items() if k < n}}


def build(cfg, traffic, seed, device, engine=None):
    """The warmed cell of this configuration under ``traffic``."""
    cell = LowfsLoop(engine or program(cfg, device), cfg, traffic, seed, device)
    cell.warm(traffic['warm_calls'])
    return cell


def judge(answers, cfg, traffic, seed, device):
    """The compared numbers of each frame of a seeded sample of the kept ones: the
    frame's and the estimates' widest gaps from the float64 reference."""
    ref = LowfsReference(cfg, 'f64', device)
    out = []
    for k in gen.judge_sample(seed, answers['frames'], traffic['judge_frames']):
        want = ref.frame(torch.as_tensor(answers['inputs'][k], device=device).double())
        est = torch.as_tensor(answers['estimates'][k], device=device).double()
        out.append({'frame_err': peak_error(answers['frames'][k].to(device), want),
                    'est_err': float(torch.max(torch.abs(est - ref.estimate(want))))})
    return out
