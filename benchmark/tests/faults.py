"""Faults planted in the program, one function each, for the fault tests: each breaks the
timed path underneath the harness in the process that calls it."""
import torch


def lowfs_estimate_altered():
    """The LOWFS estimates come out 0.05 nm off where they are produced."""
    from prysm_tpu_torch.examples import lowfs_realtime as lr
    sense = lr.sense
    lr.sense = lambda frame, R, I0: sense(frame, R, I0) + 0.05


def lowfs_frame_altered():
    """The LOWFS frame comes out 0.1% bright where it is produced."""
    from prysm_tpu_torch.examples import lowfs_realtime as lr
    render = lr.render
    lr.render = lambda *a, **k: render(*a, **k) * 1.001


def wfc_state_unchanged():
    """The control step returns no change: zero gradients."""
    from prysm_tpu_torch import steps
    call = steps._WavefrontControl.__call__

    def broken(self, actuators, coefs):
        loss, ga, gc = call(self, actuators, coefs)
        return loss, torch.zeros_like(ga), torch.zeros_like(gc)
    steps._WavefrontControl.__call__ = broken


def wfc_act_grad_altered():
    """The control step's actuator gradient comes out 1% high."""
    from prysm_tpu_torch import steps
    call = steps._WavefrontControl.__call__

    def broken(self, actuators, coefs):
        loss, ga, gc = call(self, actuators, coefs)
        return loss, ga * 1.01, gc
    steps._WavefrontControl.__call__ = broken


def wfc_coef_grad_altered():
    """The control step's coefficient gradient (the Zernike kernel's backward) comes out
    1% high where it is produced."""
    from prysm_tpu_torch import steps
    call = steps._WavefrontControl.__call__

    def broken(self, actuators, coefs):
        loss, ga, gc = call(self, actuators, coefs)
        return loss, ga, gc * 1.01
    steps._WavefrontControl.__call__ = broken


def wfc_coef_grad_nan():
    """One element of the control step's coefficient gradient comes out NaN."""
    from prysm_tpu_torch import steps
    call = steps._WavefrontControl.__call__

    def broken(self, actuators, coefs):
        loss, ga, gc = call(self, actuators, coefs)
        gc = gc.clone()
        gc[-1] = float('nan')
        return loss, ga, gc
    steps._WavefrontControl.__call__ = broken


def sense_frame_nan():
    """One sample of the sensor frame comes out NaN."""
    from prysm_tpu_torch import steps
    sensor = steps._WavefrontControl.sensor

    def broken(self, actuators, coefs):
        frame = sensor(self, actuators, coefs).clone()
        frame[0, 0] = float('nan')
        return frame
    steps._WavefrontControl.sensor = broken


def sense_frame_altered():
    """The sensor frame comes out with one lenslet's spot 1% bright."""
    from prysm_tpu_torch import steps
    sensor = steps._WavefrontControl.sensor

    def broken(self, actuators, coefs):
        frame = sensor(self, actuators, coefs).clone()
        n = frame.shape[-1] // 2
        frame[n - 16:n + 16, n - 16:n + 16] *= 1.01
        return frame
    steps._WavefrontControl.sensor = broken


def broadband_half_batch():
    """Each rank takes the mean over half of its wavelengths, leaving the rest out."""
    from prysm_tpu_torch.parallel import sharding
    from prysm_tpu_torch.parallel.broadband import SpectralMDFT
    psf = sharding.broadband_psf

    def broken(coefs, amp, modes, wavelengths, weights, plan):
        h = max(1, len(wavelengths) // 2)
        half = SpectralMDFT(Ex=plan.Ex[:h], Ey=plan.Ey[:h], norm=plan.norm[:h],
                            pupil_dx=plan.pupil_dx, focal_dx=plan.focal_dx)
        return psf(coefs, amp, modes, wavelengths[:h], weights[:h] * (len(weights) / h), half)
    sharding.broadband_psf = broken


def broadband_no_exchange():
    """The sharded loss's all-reduces are left out: each rank keeps its own part."""
    from prysm_tpu_torch.parallel import sharding
    sharding.psum = lambda x, mesh, axis: x


def broadband_grad_altered():
    """The sharded step's gradient comes out 1% high where it is produced."""
    from prysm_tpu_torch import parallel
    from prysm_tpu_torch.parallel import sharding
    build = sharding.shard_broadband_step

    def broken(*args, **kwargs):
        step = build(*args, **kwargs)

        def altered(coefs):
            loss, grad = step(coefs)
            return loss, grad * 1.01
        return altered
    sharding.shard_broadband_step = parallel.shard_broadband_step = broken
