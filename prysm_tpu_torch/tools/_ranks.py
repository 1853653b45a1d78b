"""The ranks of a tool: one process each, NCCL over one card each or gloo on the CPU."""
import datetime
import os
import queue
import socket
import tempfile
import traceback

import torch
import torch.distributed as dist


def free_port():
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def available(cpu):
    """The most ranks the tool can spawn: the cards, or 8 gloo ranks on the CPU."""
    return 8 if cpu else torch.cuda.device_count()


def _rank_main(rank, world, init, cpu, target, args, results):
    try:
        if cpu:
            torch.set_num_threads(1)
            dev = torch.device('cpu')
        else:
            dev = torch.device('cuda', rank)
            torch.cuda.set_device(dev)
        dist.init_process_group('gloo' if cpu else 'nccl', init_method=init, rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=600))
        from ..conf import config
        config.device = str(dev)
        results.put((rank, 'ok', target(rank, world, dev, *args)))
    except BaseException:  # every failure goes back to the parent, which raises it
        results.put((rank, 'error', traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world, cpu, args=(), timeout=900):
    """``[target(rank, world, device, *args) for each rank]``, one spawned process a rank.

    ``target`` is a module-level function.  The group meets over
    ``tcp://localhost`` at a free port (NCCL) or a ``file://`` rendezvous in a
    temporary directory (gloo).  A rank's exception is raised here as a
    RuntimeError with its traceback; ranks still running after ``timeout``
    seconds are terminated and raise too.
    """
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = (f'file://{os.path.join(tmp, "rendezvous")}' if cpu
                else f'tcp://localhost:{free_port()}')
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, cpu, target, args, results))
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
            errors.append(f'no result within {timeout} s from ranks '
                          f'{sorted(set(range(world)) - set(got))}')
        finally:
            for p in procs:
                p.join(timeout=60)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return [got[r] for r in range(world)]
