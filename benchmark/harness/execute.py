"""One run of one cell in one process (or one rank of a distributed cell).

The order is the contract's: build and warm the cell (set-up, counted to the
first timed call), the measured window, the traced slice (traced runs), the
device's memory peak, the metric readers, then the program's state freed and
the judge's reference run over the kept answers.  Rank 0 of a distributed
cell gathers every rank's answers and judges them; the other ranks return
their own device numbers only.
"""
import gc
import importlib
import time

import torch
import torch.distributed as dist

from . import spec, trace
from .cell import run_window


def _agree(device):
    """A decision every rank takes alike: all must have found device operations."""
    def agree(found):
        if not dist.is_initialized():
            return found
        flag = torch.tensor([int(found)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())
    return agree


def execute(job, device, rank=0):
    """Run the cell of ``job`` on ``device``; returns this process's record.

    job: {'config', 'traffic', 'seed', 'seconds', 'trace', 't0' (perf_counter at the
    process start), 'metrics': [(name, unit), ...]}; the CPU tests add 'sizes' and
    'mix', numbers that replace the configuration's and the traffic's; a control run
    (``calibrate.py``) adds 'control', the precision of the reference put in the
    program's place; the fault tests add 'fault', ``module:function`` that breaks the
    program in this process before it is built.
    """
    device = torch.device(device)
    cfg, mod = spec.config(job['config'])
    cfg = {**cfg, **job.get('sizes', {})}
    traffic = {**spec.traffic(job['traffic']), **job.get('mix', {})}
    if job.get('fault'):  # the tests' faults, planted in the program before it is built
        module, name = job['fault'].split(':')
        getattr(importlib.import_module(module), name)()
    engine = None
    if job.get('control'):
        engine = mod.control(cfg, job['seed'], device, job['control'])
    cell = mod.build(cfg, traffic, job['seed'], device, engine=engine)
    if hasattr(cell, 'plan_window'):
        cell.plan_window(job['seconds'])
    cell.finish()
    if dist.is_initialized():
        dist.barrier()
    setup_s = time.perf_counter() - job['t0']
    window_s, calls = run_window(cell, job['seconds'])
    run = {'setup_s': setup_s, 'window_s': window_s, 'calls': calls, 'device': device,
           'cfg': cfg, 'traffic': traffic,
           'probes': getattr(cell.engine, 'probes', {})}
    if hasattr(cell, 'latencies'):
        run['latency_ms'] = cell.latencies(calls)
    if job['trace']:
        def slice_calls(n, first=calls):
            for i in range(n):
                cell.call(first + i)
            cell.finish()
        run['trace'], _ = trace.profile_slice(slice_calls, traffic['trace_calls'],
                                              _agree(device))
    cuda = device.type == 'cuda'
    record = {'rank': rank, 'calls': calls, 'window_s': window_s, 'setup_s': setup_s,
              'memory_peak_bytes': torch.cuda.max_memory_allocated(device) if cuda else 0,
              'trace': run.get('trace')}
    if rank == 0:
        metrics = {}
        for name, unit in job['metrics']:
            value = spec.metric_reader(name)(run)
            if value is not None:
                metrics[name] = {'value': value, 'unit': unit}
        record['metrics'] = metrics
        record['kind'] = torch.cuda.get_device_name(device) if cuda else 'cpu'
    # what the cell says of its own window (a control loop's loss), for standard error
    record['notes'] = cell.notes(calls) if hasattr(cell, 'notes') else {}
    answers = cell.answers(calls)
    run.clear()
    cell.free()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if getattr(mod, 'DISTRIBUTED', False):
        if dist.is_initialized():
            gathered = [None] * dist.get_world_size() if rank == 0 else None
            dist.gather_object(answers, gathered, dst=0)
            answers = gathered
        else:
            answers = [answers]
    if rank == 0:
        t = time.perf_counter()
        record['judged'] = mod.judge(answers, cfg, traffic, job['seed'], device)
        record['limits'] = cfg['limits'][traffic['entry']]
        record['judge_s'] = time.perf_counter() - t
    return record
