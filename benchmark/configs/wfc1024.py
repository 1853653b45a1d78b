"""The wavefront-control step and the Shack-Hartmann frame, through
``prysm_tpu_torch.steps.build_wavefront_control``.

The pupil (with the seed's 36 coefficients) and the DM (with the seed's
actuators) are made through the port's API and handed to
``build_wavefront_control``.

* Entry ``control``: each step uploads the drifting coefficients (36
  floats), takes the loss and its gradients with respect to the actuators
  and the coefficients, reads the loss to the host (a user's convergence
  check) and moves the actuators by a fixed-gain step against their
  gradient, on the card: ``a -= gain * grad``, the gain fixed once from the
  seeded state's gradient so that the first step moves the actuators
  ``gain_first_step_nm`` rms.  The loop converges as a user's does: the
  gradients shrink over the window.  The judge compares both gradients,
  each against the reference's at the seeded state (step 0, always judged),
  a scale that does not vanish as the loop converges; the loss's error does
  not separate the program's TF32 from the bfloat16 control (PERF.md), so
  it is not compared.
* Entry ``sense``: each frame is the sensor's image at a drifting state
  (coefficients and actuators from tables on the card); frames stay on the
  card and the window ends with one wait.
"""
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from benchmark.harness import traffic as gen
from benchmark.harness.cell import Cell
from benchmark.reference.common import peak_error
from benchmark.reference.wfc1024 import WfcReference, nms_to


@dataclass
class Engine:
    """(actuators, coefs) -> (loss, actuator gradient, coefficient gradient), and -> frame;
    ``probes``: the program's inputs that the per-layer readers time alone."""
    step: Callable
    sensor: Callable
    probes: dict = field(default_factory=dict)


def state(cfg, seed):
    """(coefficients (K,), actuators (nact, nact)), nm, float64: the seed's starting state."""
    g = gen.rng(seed, gen.STATE)
    K = len(nms_to(cfg['n_max']))
    coefs = g.standard_normal(K) * (cfg['coef_rms_nm'] / np.sqrt(K))
    return coefs, g.standard_normal((cfg['nact'], cfg['nact'])) * cfg['act_rms_nm']


def program(cfg, seed, device):
    """The port's wavefront-control step built at the seed's state."""
    from prysm_tpu_torch import steps
    from prysm_tpu_torch.coordinates import make_xy_grid
    from prysm_tpu_torch.geometry import gaussian
    from prysm_tpu_torch.x.dm import DM
    fixed = {'wvl': steps.WVL, 'efl': steps.EFL, 'diameter': steps.DIAMETER,
             'sh_samples': steps.SH_SAMPLES, 'sh_spot': steps.SH_SPOT}
    if any(cfg[k] != v for k, v in fixed.items()):
        raise ValueError(f'the step no longer runs this configuration: {fixed}')
    nms = nms_to(cfg['n_max'])
    coefs, actuators = state(cfg, seed)
    N = cfg['N']
    pupil = steps.make_pupil(N, nms, tuple(coefs), device=device)
    x, y = make_xy_grid(N, diameter=cfg['diameter'], device=device)
    dm = DM(gaussian(cfg['act_sep'] * pupil.dx, x, y), Nout=N, Nact=cfg['nact'],
            sep=cfg['act_sep'], rot=tuple(cfg['rot']))
    dm.update(torch.as_tensor(actuators, dtype=torch.float32, device=device))
    wfc = steps.build_wavefront_control(N=N, nact=cfg['nact'], fN=cfg['fN'],
                                        matmul_precision=cfg['matmul_precision'],
                                        pupil=pupil, dm=dm, device=device)
    return Engine(step=wfc, sensor=wfc.sensor,
                  probes={'zernike': (pupil.coefs, pupil.nms, pupil.r, pupil.t),
                          'dm': (dm, dm.actuators)})


def control(cfg, seed, device, prec='bf16'):
    """The plain reference in the program's place, at a lower precision."""
    ref = WfcReference(cfg, prec, device)
    return Engine(step=ref.step, sensor=ref.sensor)


def _as(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


class WfcControl(Cell):
    """The control loop; ``call(k)`` is step k."""

    def __init__(self, engine, cfg, traffic, seed, device):
        super().__init__(device)
        self.engine = engine
        coefs, self.a0 = state(cfg, seed)
        self.coefs = coefs + gen.drift(seed, gen.DRIFT, traffic['table_steps'], len(coefs),
                                       traffic['coef_drift_rms_nm'], traffic['drift_corr_steps'])
        self.first_step = traffic['gain_first_step_nm']
        self.gain = None  # fixed by the first call, at the seeded state
        self.losses = []
        cuda = self.device.type == 'cuda'
        self.c_pin = torch.zeros(len(coefs), dtype=torch.float32, pin_memory=cuda)
        self.c_host = self.c_pin.numpy()
        self.c_dev = torch.zeros(len(coefs), dtype=torch.float32, device=self.device)
        self.every, self.offset = traffic['keep_every'], gen.keep_offset(seed, traffic['keep_every'])
        self.reset()

    def reset(self):
        self.a = _as(self.a0, self.device)
        self.kept = {}
        self.losses.clear()

    def call(self, k):
        self.c_host[:] = self.coefs[k % len(self.coefs)]
        self.c_dev.copy_(self.c_pin, non_blocking=True)
        loss, ga, gc = self.engine.step(self.a, self.c_dev)
        if k == 0 or k % self.every == self.offset:  # step 0: the seeded state's own
            self.kept[k] = (self.a, self.c_host.copy(), ga, gc)
        if self.gain is None:
            rms = torch.sqrt(torch.mean(ga * ga)).clamp_min(torch.finfo(ga.dtype).tiny)
            self.gain = self.first_step / rms
        self.a = self.a - self.gain * ga
        # the user's convergence check reads the loss every step
        self.losses.append(loss.item())

    def notes(self, calls):
        """The loss over the window: at its start, its least, at its end."""
        seen = self.losses[:calls]
        return {'loss_first': seen[0], 'loss_min': min(seen), 'loss_last': seen[-1]}

    def answers(self, calls):
        return {'kept': {k: (a.cpu(), c, ga.cpu(), gc.cpu())
                         for k, (a, c, ga, gc) in self.kept.items() if k < calls}}


class WfcSense(Cell):
    """Sensor frames at a drifting state; ``call(k)`` is frame k."""

    def __init__(self, engine, cfg, traffic, seed, device):
        super().__init__(device)
        self.engine = engine
        self.coefs, self.actuators = sense_states(cfg, traffic, seed, device)
        self.every, self.offset = traffic['keep_every'], gen.keep_offset(seed, traffic['keep_every'])
        self.reset()

    def reset(self):
        self.kept = {}

    def call(self, k):
        j = k % len(self.coefs)
        frame = self.engine.sensor(self.actuators[j], self.coefs[j])
        if k % self.every == self.offset:
            self.kept[k] = frame

    def answers(self, calls):
        return {'frames': {k: f.cpu() for k, f in self.kept.items() if k < calls}}


def sense_states(cfg, traffic, seed, device):
    """(coefficient table (T, K), actuator table (T, nact, nact)), float32 on ``device``."""
    coefs, actuators = state(cfg, seed)
    T = traffic['table_steps']
    dc = gen.drift(seed, gen.DRIFT, T, len(coefs), traffic['coef_drift_rms_nm'],
                   traffic['drift_corr_steps'])
    da = gen.drift(seed, gen.DRIFT2, T, actuators.size, traffic['act_drift_rms_nm'],
                   traffic['drift_corr_steps'])
    return (_as(coefs + dc, device),
            _as(actuators[None] + da.reshape((T,) + actuators.shape), device))


CELLS = {'control': WfcControl, 'sense': WfcSense}


def build(cfg, traffic, seed, device, engine=None):
    """The warmed cell of this configuration under ``traffic``."""
    cell = CELLS[traffic['entry']](engine or program(cfg, seed, device), cfg, traffic, seed,
                                   device)
    cell.warm(traffic['warm_calls'])
    return cell


def judge(answers, cfg, traffic, seed, device):
    """The compared numbers of each call of a seeded sample of the kept ones, against
    the float64 reference: a frame's error over the reference frame's peak; a
    control step's gradient errors over the peak of the reference's gradient at the
    seeded state (step 0, which the sample always holds)."""
    ref = WfcReference(cfg, 'f64', device)
    out = []
    if traffic['entry'] == 'sense':
        coefs, actuators = sense_states(cfg, traffic, seed, 'cpu')
        for k in gen.judge_sample(seed, answers['frames'], traffic['judge_calls']):
            j = k % len(coefs)
            want = ref.sensor(actuators[j].to(device).double(), coefs[j].to(device).double())
            out.append({'frame_err': peak_error(answers['frames'][k].to(device), want)})
        return out
    scale = None
    for k in gen.judge_sample(seed, answers['kept'], traffic['judge_calls']):
        a, c, ga, gc = answers['kept'][k]
        _, GA, GC = ref.step(a.to(device).double(), torch.as_tensor(c, device=device).double())
        if scale is None:  # step 0
            scale = (GA, GC)
        out.append({'act_grad_err': peak_error(ga.to(device), GA, scale[0]),
                    'coef_grad_err': peak_error(gc.to(device), GC, scale[1])})
    return out
