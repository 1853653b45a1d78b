"""A distributed cell's ranks: one spawned process a card (NCCL) or a CPU rank (gloo).

The ranks meet over ``tcp://localhost`` at a free port; the parent touches
no card, so each card holds one process.  Every rank runs
``execute.execute`` and sends its record back; a rank's failure, or ranks
still running at the deadline, raise here after every rank has been ended.
"""
import datetime
import queue
import socket
import traceback

import torch
import torch.distributed as dist


def free_port():
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank, world, init, cpu, job, results):
    try:
        if cpu:
            torch.set_num_threads(1)
            device = torch.device('cpu')
        else:
            device = torch.device('cuda', rank)
            torch.cuda.set_device(device)
        dist.init_process_group('gloo' if cpu else 'nccl', init_method=init, rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        from prysm_tpu_torch.conf import config
        config.device = str(device)
        from .execute import execute
        from .guard import forbidden_modules
        import sys
        if 'seeds' in job:  # calibration: one record a seed, in one process group
            record = [execute({**job, 'seed': s}, device, rank) for s in job['seeds']]
        else:
            record = execute(job, device, rank)
            record['forbidden'] = forbidden_modules(sys.modules)
        results.put((rank, 'ok', record))
    except BaseException:  # every failure goes back to the parent, which raises it
        results.put((rank, 'error', traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job, world, cpu=False, timeout=330):
    """[record of rank 0, 1, ...] of ``job`` run on ``world`` ranks."""
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    init = f'tcp://localhost:{free_port()}'
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, cpu, job, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) < world:
            rank, status, payload = results.get(timeout=timeout)
            if status != 'ok':
                errors.append(f'rank {rank}:\n{payload}')
                break
            got[rank] = payload
    except queue.Empty:
        errors.append(f'no record within {timeout} s from ranks '
                      f'{sorted(set(range(world)) - set(got))}')
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError('\n'.join(errors))
    return [got[r] for r in range(world)]
