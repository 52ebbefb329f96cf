"""Mesh scaling of the sharded consume and screen; the port's counterpart
of ``tools/scaling_bench.py``.

The reference scales with k-mer banding: N serial passes, each counting
1/N of the hash space (its docs/banding.rst), scattered over processes.
The port's replacement is a hash-sharded sketch over a ('data', 'shard')
mesh (:mod:`kevlar_tpu_torch.parallel`); this measures that path over
meshes whose every cell names ``--device`` (one card named n times, or
the CPU), as the JAX tool measures it over virtual CPU devices:

1. **Shard-axis scaling** (1/2/4/8 cells, one process) at a constant
   total batch (65,536 reads a rep).  Two consume routes:

   - ``alltoall`` (the default route): reads cut over both mesh axes,
     each k-mer hashed once and routed to its owner shard (``kt_route``,
     the all_to_all's parts, ``kt_scatter_add`` over them).  Total work
     is constant in n, so on cells that serialize the ideal wall is flat:
     ``routed_strong_efficiency = wall_1 / wall_n``.
   - ``replicate``: every shard hashes every k-mer and drops what lies
     outside its range (K1 and the range ``kt_consume``): n-fold redundant
     work, reported as ``replicate_serialized_efficiency = n * wall_1 /
     wall_n``, with ``alltoall_speedup = wall_replicate /
     wall_alltoall``.

   The screen (the range K2 on every shard, a ``pmin`` over them) keeps
   ``screen_serialized_efficiency``.

2. **Data-axis partitioning at equal total work**: 1 cell against N (N =
   ``min(cpu_count, 8)``) over the same batch.

3. **Multi-process (gloo) runs**: the shard-axis program with the mesh
   spanning 2 x 4 and 4 x 2 processes x cells, every crossing through
   ``torch.distributed``'s gloo back end; ``vs_single_process_*`` against
   the one-process 8-cell row.

Usage:
    python -m kevlar_tpu_torch.bench.scaling [--out PATH] [--device cuda|cpu]
    python -m kevlar_tpu_torch.bench.scaling --worker --ndev N --n-data D
        --n-shard S [--distributed COORD NPROC PID] [--bmul M] [--out PATH]
        [--device cuda|cpu]

``--ndev n`` (n > 0) builds the mesh from n cells that all name
``--device``; ``--ndev 0`` from every card (``--device cuda``; after
``--distributed``, every rank's cards).  Each worker is a process of its
own (``python -m kevlar_tpu_torch.bench.scaling --worker``).  The result
is written only where ``--out`` says.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kevlar_tpu_torch.bench import add_device_arg, start
from kevlar_tpu_torch.parallel import (ShardedSketch, init_distributed,
                                       make_mesh, sharded_novel_screen)

# the directory that holds the package: the workers' PYTHONPATH
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

B_TOTAL = 65536   # reads per rep (amortizing: dispatch/marshal << compute)
L = 160           # padded read length
READLEN = 150
KSIZE = 31
SHARD_TABLESIZE = 262144   # buckets per shard (constant: weak memory scaling)
REPS = 2
GLOO_WAIT = 1200  # seconds the gloo ranks may take together


def _sync(mesh):
    """Wait for every card cell of ``mesh`` this rank owns."""
    for dev in {mesh.devices[d][s] for d, s in mesh.local_cells()}:
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)


def _first_table(sketch):
    """This rank's first cell's table on the host (JAX's
    ``tables.addressable_shards[0]``)."""
    d, s = sketch.mesh.local_cells()[0]
    return sketch.tables[d][s].cpu()


def worker(ndev, n_data, n_shard, out, distributed=None, bmul=None,
           routes=('alltoall', 'replicate'), screen=True, device='cuda'):
    """One mesh's consume and screen walls; writes the row to ``out``
    (rank 0's, where given) and returns it."""
    device = torch.device(device)
    devices = None
    if distributed:
        coord, nproc, pid = distributed
        init_distributed(coord, num_processes=int(nproc),
                         process_id=int(pid), backend='gloo')
        if ndev:
            devices = [(rank, device) for rank in range(int(nproc))
                       for _ in range(ndev)]
    elif ndev:
        devices = [device] * ndev
    mesh = make_mesh(n_data=n_data, n_shard=n_shard, devices=devices,
                     device=device)

    rng = np.random.default_rng(4242)
    nreads = B_TOTAL * (bmul if bmul else 1)
    bases = rng.integers(0, 4, size=(nreads, L)).astype(np.uint8)
    bases[:, READLEN:] = 4
    lengths = np.full((nreads,), READLEN, dtype=np.int32)

    case = ShardedSketch(mesh, KSIZE, SHARD_TABLESIZE * n_shard)
    mom = ShardedSketch(mesh, KSIZE, SHARD_TABLESIZE * n_shard)
    dad = ShardedSketch(mesh, KSIZE, SHARD_TABLESIZE * n_shard)

    result = {
        'devices': len(mesh.cells()), 'n_data': n_data, 'n_shard': n_shard,
        'reads_per_rep': nreads, 'reps': REPS,
    }

    for route in routes:
        for sk in (case, mom, dad):       # warm up
            sk.consume_batch(bases, route=route)
        _sync(mesh)
        t0 = time.time()
        for _ in range(REPS):
            case.consume_batch(bases, route=route)
        _sync(mesh)
        _first_table(case)
        wall = time.time() - t0
        result['consume_{}_s'.format(route)] = round(wall, 3)
        result['consume_{}_reads_per_s'.format(route)] = round(
            nreads * REPS / wall)

    if screen:
        res = sharded_novel_screen(mesh, [case], [mom, dad], bases, lengths,
                                   casemin=2, ctrlmax=255)
        res[0].cpu()                      # warm up
        _sync(mesh)
        t0 = time.time()
        for _ in range(REPS):
            res = sharded_novel_screen(mesh, [case], [mom, dad], bases,
                                       lengths, casemin=2, ctrlmax=255)
            _sync(mesh)
            res[0].cpu()
        wall = time.time() - t0
        result['screen_s'] = round(wall, 3)
        result['screen_reads_per_s'] = round(nreads * REPS / wall)

    if out and (not distributed or int(distributed[2]) == 0):
        with open(out, 'w') as fh:
            json.dump(result, fh)
    return result


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    return env


def _worker_cmd(ndev, n_data, n_shard, out, device):
    return [sys.executable, '-m', 'kevlar_tpu_torch.bench.scaling',
            '--worker', '--ndev', str(ndev), '--n-data', str(n_data),
            '--n-shard', str(n_shard), '--out', out, '--device', str(device)]


def _tail(path, nbytes=2000):
    with open(path, 'rb') as fh:
        fh.seek(0, os.SEEK_END)
        fh.seek(max(0, fh.tell() - nbytes))
        return fh.read().decode(errors='replace')


def run_subprocess(ndev, n_data, n_shard, tag, tmpdir, bmul=None,
                   device='cuda'):
    out = os.path.join(tmpdir, 'scale_{}.json'.format(tag))
    cmd = _worker_cmd(ndev, n_data, n_shard, out, device)
    if bmul:
        cmd += ['--bmul', str(bmul)]
    proc = subprocess.run(cmd, cwd=tmpdir, env=_env(),
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    if proc.returncode != 0:
        raise RuntimeError('worker {} exited {}: {}'.format(
            tag, proc.returncode,
            proc.stderr.decode(errors='replace')[-2000:]))
    with open(out) as fh:
        return json.load(fh)


def _free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def run_gloo(tmpdir, nproc, ndev_each, device='cuda'):
    """nproc processes x ndev_each cells, the shard axis spanning the
    processes.  A rank that fails or outlasts :data:`GLOO_WAIT` fails the
    run, and every rank still running is killed."""
    out = os.path.join(tmpdir, 'scale_gloo{}.json'.format(nproc))
    coord = 'localhost:{}'.format(_free_port())
    procs, logs = [], []
    try:
        for pid in range(nproc):
            cmd = _worker_cmd(ndev_each, 1, 8, out, device) + [
                '--distributed', coord, str(nproc), str(pid)]
            logs.append(os.path.join(tmpdir, 'gloo{}_{}.log'.format(
                nproc, pid)))
            with open(logs[-1], 'wb') as log:
                procs.append(subprocess.Popen(
                    cmd, cwd=tmpdir, env=_env(), stdout=subprocess.DEVNULL,
                    stderr=log))
        deadline = time.time() + GLOO_WAIT
        while any(p.poll() is None for p in procs):
            failed = [i for i, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                i = failed[0] if failed else 0
                raise RuntimeError('gloo worker {} of {} {}: {}'.format(
                    i, nproc, 'failed' if failed else 'timed out',
                    _tail(logs[i])))
            time.sleep(0.2)
        for i, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError('gloo worker {} of {} failed: {}'.format(
                    i, nproc, _tail(logs[i])))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(out) as fh:
        return json.load(fh)


def _note(device, cores):
    if device.type == 'cuda':
        where = ('every mesh names one {} n times: its cells share the card '
                 'and serialize, as JAX\'s virtual CPU devices do; no NVLink, '
                 'multi-card or cross-host figure'.format(
                     torch.cuda.get_device_name(device)))
    else:
        where = ('every mesh names the CPU n times: its cells share the host '
                 'and serialize')
    return ('{} ({} host cores) at amortizing batch sizes ({} reads/rep). The '
            'routed (all_to_all) consume does constant total work, so its '
            'ideal serialized wall is flat: routed_strong_efficiency = '
            'wall_1/wall_n. The replicate route does n-fold redundant work '
            'and keeps serialized_efficiency = n*wall_1/wall_n. The data-axis '
            'row partitions the SAME batch over 1 vs N cells (equal total '
            'work). Gloo rows add the cross-process cost (ranks on the same '
            'device, every crossing through host memory) at equal cell '
            'count.'.format(where, cores, B_TOTAL))


def main(argv=None):
    """Run the measurement (or, with ``--worker``, one mesh's row);
    returns what it measured."""
    ap = argparse.ArgumentParser(
        description='sharded consume and screen over meshes of 1-8 cells')
    ap.add_argument('--worker', action='store_true')
    ap.add_argument('--ndev', type=int, default=0)
    ap.add_argument('--n-data', type=int, default=1)
    ap.add_argument('--n-shard', type=int, default=1)
    ap.add_argument('--out', default=None,
                    help='write the result as JSON here (default: nowhere)')
    ap.add_argument('--distributed', nargs=3, default=None,
                    metavar=('COORD', 'NPROC', 'PID'))
    ap.add_argument('--bmul', type=int, default=None,
                    help='batch multiplier override (equal-total-work runs)')
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = start(args.device)
    if args.worker:
        res = worker(args.ndev, args.n_data, args.n_shard, args.out,
                     args.distributed, bmul=args.bmul, device=args.device)
        if args.distributed:
            torch.distributed.destroy_process_group()
        print(json.dumps(res))
        return res

    cores = os.cpu_count()
    results = {'host_physical_cores': cores,
               'reads_per_rep': B_TOTAL,
               'note': _note(device, cores)}
    with tempfile.TemporaryDirectory(prefix='kevlar_scaling_') as tmpdir:
        _measure(results, tmpdir, cores, args.device)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(results, fh, indent=1)
        print('# wrote', args.out, file=sys.stderr)
    return results


def _measure(results, tmpdir, cores, device):
    print('# shard-axis scaling, constant total batch', file=sys.stderr)
    shard_rows = []
    for n in (1, 2, 4, 8):
        row = run_subprocess(n, 1, n, 'shard{}'.format(n), tmpdir,
                             device=device)
        shard_rows.append(row)
    base = shard_rows[0]
    for row in shard_rows:
        n = row['devices']
        row['routed_strong_efficiency'] = round(
            base['consume_alltoall_s'] / row['consume_alltoall_s'], 3)
        row['replicate_serialized_efficiency'] = round(
            n * base['consume_replicate_s'] / row['consume_replicate_s'], 3)
        row['alltoall_speedup'] = round(
            row['consume_replicate_s'] / row['consume_alltoall_s'], 3)
        row['screen_serialized_efficiency'] = round(
            n * base['screen_s'] / row['screen_s'], 3)
        print(json.dumps(row), flush=True)
    results['shard_axis'] = shard_rows

    print('# data-axis partitioning overhead at equal total work',
          file=sys.stderr)
    ndev = min(cores, 8)
    d1 = run_subprocess(1, 1, 1, 'data1', tmpdir, device=device)
    dn = run_subprocess(ndev, ndev, 1, 'data{}'.format(ndev), tmpdir,
                        device=device)
    data = {'1_device': d1, 'N_devices_same_batch': dn,
            'consume_efficiency': round(
                d1['consume_alltoall_s'] / dn['consume_alltoall_s'], 3),
            'screen_efficiency': round(
                d1['screen_s'] / dn['screen_s'], 3)}
    results['data_axis'] = data
    print(json.dumps(data), flush=True)

    for nproc, ndev_each in ((2, 4), (4, 2)):
        print('# {}-process gloo, 8 cells in all'.format(nproc),
              file=sys.stderr)
        try:
            gloo = run_gloo(tmpdir, nproc, ndev_each, device=device)
            single8 = shard_rows[-1]
            for key in ('consume_alltoall_s', 'consume_replicate_s',
                        'screen_s'):
                if key in gloo and key in single8:
                    gloo['vs_single_process_' + key.replace('_s', '')] = \
                        round(single8[key] / gloo[key], 3)
            results['gloo_{}proc'.format(nproc)] = gloo
            print(json.dumps(gloo), flush=True)
        except Exception as exc:
            results['gloo_{}proc'.format(nproc)] = {'error': str(exc)}
            print('# gloo run failed:', exc, file=sys.stderr)


if __name__ == '__main__':
    main()
